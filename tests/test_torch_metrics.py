"""Port parity of every metric: the (N, M) gram of each against the JAX
package's (float64, JAX x64, at 1e-10; float32 at 1e-4 / 1e-5), a params
dict of R rows against the rows one at a time, ``input_sensitivity``, the
gradient through the tie-safe |a - b| at the gram diagonal (against
``jax.grad``), PSD_L2 at coordinates ~1 and ~1e2, and the metrics of
tests/test_zoo.py's ``TestMetricVariants`` in a GP (exp of a distance
metric, the dot metrics under ``KernelDot``): logp, ``dlogp`` and
predict."""

import jax
import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from torch_parity import F32_TOL, assert_close, check_gp, floatx, jax_eager, zoo_data

METRICS = ["One", "Delta", "DeltaEq", "DeltaEq2", "Minimum", "Difference", "L1", "L2",
           "ARD_L1", "ARD_L2", "ARD_Dot", "ARD_DotBias", "PSD_Dot", "PSD_L2"]


def _metric_pair(mname, x, seed=0):
    """The metric in both packages with hypers named under ``M_`` and
    random positive values (float64 host arrays)."""
    kw = {"p": 2} if mname.startswith("PSD") else {}
    jm, tm = getattr(g3, mname)(x, **kw), getattr(g3t, mname)(x, **kw)
    for m in (jm, tm):
        m.check_hypers("M_")
    rng = np.random.default_rng(seed)
    params = {p.name: rng.uniform(0.3, 1.5, p.shape) for p in jm.hypers}
    return jm, tm, params


def _points(seed, n, d, scale=1.0, offset=0.0):
    """Points on a grid of 0.5 in two of every three columns (so the delta
    metrics see matches), ``offset + scale * N(0, 1)`` elsewhere."""
    rng = np.random.default_rng(seed)
    x = offset + scale * rng.standard_normal((n, d))
    x[:, ::3] = np.round(2 * x[:, ::3]) / 2
    return x


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_gram_matches_jax(name):
    x1, x2 = _points(1, 9, 3), _points(2, 6, 3)
    with floatx(name), jax_eager():
        for mname in METRICS:
            jm, tm, params = _metric_pair(mname, x1)
            params = {k: v.astype(name) for k, v in params.items()}
            tparams = {k: torch.as_tensor(v) for k, v in params.items()}
            args = [a.astype(name) for a in (x1, x2)]
            extra = {"DeltaEq": (0.5,), "DeltaEq2": (0.5, -0.5)}.get(mname, ())
            want = np.asarray(jm.gram(params, *args, *extra))
            got = tm.gram(tparams, *[torch.as_tensor(a) for a in args], *extra)
            assert got.shape == want.shape, mname
            assert_close(got, want, name, err_msg=mname)
            assert_close(tm.input_sensitivity(tparams),
                         np.asarray(jm.input_sensitivity(params)), name, err_msg=mname)


@pytest.mark.parametrize("mname", [m for m in METRICS if m != "Difference"])
def test_gram_rows_match_single_rows(mname):
    x1, x2 = _points(3, 7, 3), _points(4, 5, 3)
    with floatx("float64"):
        _, tm, params = _metric_pair(mname, x1)
        rng = np.random.default_rng(5)
        prow = {k: torch.as_tensor(v * rng.uniform(0.5, 1.5, (3,) + v.shape))
                for k, v in params.items()}
        t1, t2 = torch.as_tensor(x1), torch.as_tensor(x2)
        batched = tm.gram(prow, t1, t2)
        for r in range(3):
            one = tm.gram({k: v[r] for k, v in prow.items()}, t1, t2)
            got = batched[r] if batched.ndim == 3 else batched  # no hypers: no rows
            np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("mname", ["L1", "ARD_L1"])
def test_abs_metric_gradient_at_ties_matches_jax(mname):
    """d/drate of sum(gram(x, x)) through the diagonal's ties: both pin
    the tied entries' gradient to 0."""
    x = _points(6, 8, 2)
    with floatx("float64"), jax_eager():
        jm, tm, params = _metric_pair(mname, x)
        x_scale = jax.numpy.asarray(1.3)

        def jax_total(s):
            return jax.numpy.sum(jm.gram(params, x * s, x * s))

        want = jax.grad(jax_total)(x_scale)
        s = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
        xt = torch.as_tensor(x)
        tparams = {k: torch.as_tensor(v) for k, v in params.items()}
        tm.gram(tparams, xt * s, xt * s).sum().backward()
        np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), rtol=1e-12)
        assert np.isfinite(s.grad.numpy())


@pytest.mark.parametrize("offset", [0.0, 100.0])
def test_psd_l2_float32_at_large_coordinates(offset):
    """PSD_L2 in float32 against the JAX package's float64: the port sums
    the mapped points' differences feature by feature, so coordinates
    around 1e2 keep its float32 gram within the float32 tolerance (the
    q11 + q22 - 2 x1 M x2^T form loses ~1e-3 absolute there)."""
    x1, x2 = _points(7, 9, 3, offset=offset), _points(8, 6, 3, offset=offset)
    with floatx("float64"), jax_eager():
        jm, _, params = _metric_pair("PSD_L2", x1)
        want = np.asarray(jm.gram(params, x1, x2))
    with floatx("float32"):
        _, tm, _ = _metric_pair("PSD_L2", x1)
        got = tm.gram({k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()},
                      torch.as_tensor(x1, dtype=torch.float32),
                      torch.as_tensor(x2, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("mname", ["ARD_L1", "ARD_L2", "L1", "L2", "PSD_L2"])
def test_distance_metric_under_exp_in_gp(mname):
    x = zoo_data()[0]
    kw = {"p": 2} if mname == "PSD_L2" else {}
    check_gp("ZT" + mname, lambda lib: lib.hypers.kernels.KernelStationaryExponential(
        x, metric=getattr(lib, mname)(x, **kw)))


@pytest.mark.parametrize("mname", ["ARD_Dot", "ARD_DotBias", "PSD_Dot"])
def test_dot_metric_under_kernel_dot_in_gp(mname):
    x = zoo_data()[0]
    kw = {"p": 2} if mname == "PSD_Dot" else {}
    check_gp("ZD" + mname, lambda lib: lib.KernelDot(x, metric=getattr(lib, mname)(x, **kw)))
