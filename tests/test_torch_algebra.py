"""Port parity of the kernel algebra: tutorial 03's composites (SE + LIN,
SE * SIN, 2 * SE + 0.1; examples/tut03_kernels.py) and the composite of
the card's phase 9a (Linear + Bias location, SE * SIN + 2 * MAT52 + LIN +
0.1) in a GP against the JAX package — logp, ``dlogp`` (against
``jax.grad``) and predict's mean and std, float64 (JAX x64) at 1e-10, and
the phase 9a composite in float32 at 1e-4 / 1e-5 too — the product's
amplitude pin, the composites' names and ``input_sensitivity``; and which
factors of a composite reach the fused gram K1 and the panel Cholesky K2:
one K1 call per SE / MAT32 / MAT52 / RQ factor on ARD_L2 with a Param rate
and one K2 call per logp, for one params dict and for R rows alike
(tests/torch_parity.py's spy)."""

import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from torch_parity import (KernelSpy, assert_close, check_gp, floatx, jax_eager, nudged,
                          process_pair, zoo_data)

TUT03 = {
    "SE+LIN": lambda lib, x: lib.SE(x) + lib.LIN(x),
    "SE*SIN": lambda lib, x: lib.SE(x) * lib.SIN(x),
    "2*SE+1": lambda lib, x: 2.0 * lib.SE(x) + 0.1,
    "phase9a": lambda lib, x: lib.SE(x) * lib.SIN(x) + 2.0 * lib.MAT52(x) + lib.LIN(x) + 0.1,
}


@pytest.mark.parametrize("label,name", [(label, "float64") for label in sorted(TUT03)]
                         + [("phase9a", "float32")])
def test_composite_in_gp_matches_jax(label, name):
    x = zoo_data()[0]
    location = ((lambda lib: lib.Linear(x) + lib.Bias()) if label == "phase9a" else None)
    check_gp(label.replace("+", "p").replace("*", "t"), lambda lib: TUT03[label](lib, x),
             location=location, name=name)


def test_product_pins_one_amplitude_and_names():
    x = zoo_data()[0]
    for lib in (g3, g3t):
        k = lib.SE(x) * lib.SIN(x)
        assert k.k1.var is None and k.k2.var == 1.0  # SIN's amplitude is pinned to 1
        keep = lib.SE(x, var=2.0) * lib.SIN(x)
        assert keep.k2.var is None  # one side has an amplitude: nothing pinned
    jk = 2.0 * g3.SE(x) + 0.1
    tk = 2.0 * g3t.SE(x) + 0.1
    assert tk.name == jk.name and str(type(tk).__name__) == type(jk).__name__ == "KernelShift"
    assert type(tk.k_inner).__name__ == "KernelScale"


def test_input_sensitivity_matches_jax():
    x, y, _ = zoo_data(d=3)
    with floatx("float64"), jax_eager():
        jp, tp = process_pair(lambda lib: lib.GP(
            space=x, location=lib.Bias(),
            kernel=(lib.SE(x) + 2.0 * lib.OU(x)) * lib.KernelDot(x, metric=lib.ARD_Dot(x)),
            name="TIS"), x, y)
        params = nudged(jp.params_default)
        tparams = {k: torch.as_tensor(v) for k, v in params.items()}
        assert_close(tp.f_kernel.input_sensitivity(tparams),
                     np.asarray(jp.f_kernel.input_sensitivity(params)), "float64")


def _counted(lib, x):
    """Four K1 factors (SE, MAT52, MAT32 and RQ, whose amplitude the product
    pins to a 0-d 1 beside a rate of R rows) and three that must not reach
    it (OU on ARD_L1, an SE on a fixed rate, LIN)."""
    fixed = lib.SE(x, name="SEfix", metric=lib.ARD_L2(x, rate=np.full(x.shape[1], 0.7)))
    return (lib.SE(x) * lib.SIN(x) + 2.0 * lib.MAT52(x) + lib.MAT32(x)
            + lib.COS(x) * lib.RQ(x) + lib.OU(x) + fixed + lib.LIN(x) + 0.1)


def test_composite_launches_k1_per_factor_and_k2_once(monkeypatch):
    spy = KernelSpy(monkeypatch)
    x, y, _ = zoo_data()
    with floatx("float64"), jax_eager():
        jp, tp = process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(),
                                                 kernel=_counted(lib, x), name="TZC"), x, y)
        params = nudged(jp.params_default)
        spy.take()
        lp = tp.logp(params)
        assert spy.take() == (4, 1)
        np.testing.assert_allclose(lp, jp.logp(params), rtol=1e-10)
        grad = tp.dlogp(params)
        assert spy.take() == (4, 1)
        np.testing.assert_allclose(grad, np.asarray(jp.dlogp(params)), rtol=1e-10, atol=1e-10)
        # R rows: one batched K1 call a factor and one batched K2 call
        u = tp.active.dict_to_array(params)
        rows = u[None, :] + 0.05 * np.random.default_rng(2).standard_normal((5, len(u)))
        got = tp.logp_chain(rows)
        assert spy.take() == (4, 1)
        single = [tp.logp(r, array=True) for r in rows]
        np.testing.assert_allclose(got, single, rtol=1e-12)
        np.testing.assert_allclose(got[:2], [jp.logp(r, array=True) for r in rows[:2]],
                                   rtol=1e-10)
