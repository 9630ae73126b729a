"""Port parity of deep kernel learning (``g3py_tpu_torch/hypers/features.py``)
against the JAX package: the hyper names and the defaults (the seeded
LeCun weights, the base kernel's defaults on the initial features) for the
four activations, the features, ``input_sensitivity``, logp/dlogp and
predict of a GP over a DeepKernel in float64 at 1e-10, the DeepKernel
branch of ``pathwise_sampler`` fed the JAX package's draws, the
``dkl_logp``/``dkl_dlogp_norm`` pins of ``golden_families.json`` in float32
at ``test_golden_families.py``'s own 5e-5, and the square gram over the
features as one K1 call whose backward reaches the weights through both of
its inputs."""

import json
import os

import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.hypers.features import DeepKernel as JDeepKernel
from g3py_tpu_torch.hypers.features import DeepKernel

from torch_parity import (KernelSpy, assert_close, floatx, jax_eager, nudged, process_pair,
                          to_numpy)
from test_torch_pathwise import _injected

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_families.json")


def _data(n=24, d=3, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = np.tanh(x @ np.array([1.0, -0.5, 0.25])[:d]) + 0.1 * rng.standard_normal(n)
    return x, y, rng.standard_normal((6, d))


def test_golden_dkl_pins_on_the_port():
    with open(GOLDEN) as fh:
        want = json.load(fh)
    xd = np.random.default_rng(12).standard_normal((36, 3)).astype(np.float32)
    yd = (np.tanh(xd @ np.array([1.0, -0.5, 0.25], np.float32))
          + 0.1 * np.random.default_rng(13).standard_normal(36)).astype(np.float32)
    dgp = g3t.GP(space=xd, location=g3t.Bias(), kernel=DeepKernel(g3t.SE, xd, widths=(8, 2)),
                 noisy=True, name="GOLD_DKL")
    dgp.observed(xd, yd)
    np.testing.assert_allclose(dgp.logp(), want["dkl_logp"], rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(np.linalg.norm(dgp.dlogp()), want["dkl_dlogp_norm"],
                               rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("activation,base", [("tanh", "SE"), ("relu", "MAT52"),
                                             ("softplus", "RQ"), ("elu", "MAT32")])
def test_deep_kernel_gp_matches_jax(activation, base):
    x, y, xq = _data()

    def build(lib):
        kernel = (JDeepKernel if lib is g3 else DeepKernel)(
            getattr(lib, base), x, widths=(5, 2), activation=activation)
        return lib.GP(space=x, location=lib.Bias(), kernel=kernel, name="DK" + activation)

    with floatx("float64"), jax_eager():
        jp, tp = process_pair(build, x, y)
        assert [p.name for p in tp.active.ordered_params] == \
            [p.name for p in jp.active.ordered_params]
        assert_close(dict(tp.params_default), {k: np.asarray(v) for k, v in
                                                jp.params_default.items()}, "float64")
        params = nudged(jp.params_default)
        jk, tk = jp.f_kernel, tp.f_kernel
        assert_close(tk.features(params, x), jk.features(params, x), "float64")
        assert_close(tk.input_sensitivity(params), jk.input_sensitivity(params), "float64")
        assert_close(tp.logp(params), jp.logp(params), "float64")
        assert_close(tp.dlogp(params), jp.dlogp(params), "float64")
        want = jp.predict(params, xq, mean=True, std=True)
        got = tp.predict(params, xq, mean=True, std=True)
        assert_close(dict(mean=got["mean"], std=got["std"]),
                     dict(mean=want["mean"], std=want["std"]), "float64")
    with pytest.raises(ValueError):
        DeepKernel(g3t.SE, x, activation="sigmoid")


def test_deep_kernel_rows_and_k1(monkeypatch):
    """The square gram of the features is one K1 call, rows of params one
    batched call; the backward reaches the weights through both inputs of
    the gram (their gradient equals the plain form's, where both inputs
    are separate leaves)."""
    x, y, _ = _data(n=20)
    with floatx("float64"):
        tp = g3t.GP(space=x, location=g3t.Bias(), kernel=DeepKernel(g3t.SE, x, widths=(4, 2)),
                    name="DKROWS")
        tp.observed(x, y)
        reg = tp.active
        u = reg.dict_to_array(tp.params_default)
        rows = u[None, :] + 0.05 * np.random.default_rng(1).standard_normal((5, len(u)))
        spy = KernelSpy(monkeypatch)
        lr = tp.logp_chain(rows)
        assert spy.take() == (1, 1)
        np.testing.assert_allclose(lr, [tp.logp(r, array=True) for r in rows], rtol=1e-10)
        dk = tp.f_kernel
        p = {k: torch.as_tensor(np.asarray(v)).requires_grad_(True)
             for k, v in tp.params_default.items()}
        xt = torch.as_tensor(x)
        f = dk.features(p, xt)
        g = torch.randn(len(x), len(x), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
        w0 = p[dk.w[0].name]
        (grad_k1,) = torch.autograd.grad((dk.cov(p, xt) * g).sum(), w0)
        f1, f2 = dk.features(p, xt), dk.features(p, xt)
        rate, var = p[dk.base.metric.rate.name], p[dk.base.var.name]
        d2 = (((f1[:, None, :] - f2[None, :, :]) * rate) ** 2).sum(-1)
        (grad_plain,) = torch.autograd.grad((var * torch.exp(-0.5 * d2) * g).sum(), w0)
        np.testing.assert_allclose(to_numpy(grad_k1), to_numpy(grad_plain), rtol=1e-10)
        assert f.shape == (len(x), 2)


def test_deep_kernel_pathwise_matches_jax():
    """The DeepKernel branch of ``pathwise_sampler``: Fourier features of
    the base family in feature space, fed the JAX package's draws."""
    x, y, xq = _data(n=20)
    samples, nf = 4, 128

    def build(lib):
        kernel = (JDeepKernel if lib is g3 else DeepKernel)(lib.SE, x, widths=(4, 2))
        return lib.GP(space=x, location=lib.Bias(), kernel=kernel, name="DKPW")

    with floatx("float64"):
        jp, tp = process_pair(build, x, y)
        params = nudged(jp.params_default)
        jpr, tpr = jp.predictor(params), tp.predictor(g3t.params_from_jax(tp, params))
        want = jpr.pathwise_sampler(space=xq, samples=samples, key=3, n_features=nf)
        import test_torch_pathwise as tpw
        old = (tpw.F, tpw.S)
        tpw.F, tpw.S = nf, samples
        try:
            draws = _injected(params, None, [(None, False, 2)], 3, len(x), len(xq), False)
        finally:
            tpw.F, tpw.S = old
        got = tpr.pathwise_sampler(space=xq, samples=samples, key=draws, n_features=nf)
        assert_close(got, np.asarray(want), "float64")
