"""Port parity of model scoring and the leave-one-out objective:
``scores`` (``_l1``/``_l2``/``_mse``/``_rmse``/medians/``_nlpd``/``_loo``),
``loo`` and its gradient (the analytic LOO backward against JAX's autodiff
through its Cholesky), and ``find_MAP(objective='loo')`` — each against the
JAX package on the same numpy inputs.  The warped model here is
``BoxCoxLinear @ ArcsinhLinear`` (analytic forward): the Newton forward of
``WarpingTanh`` is held to the JAX package by
tests/test_torch_{root,mappings}.py and to the recorded scores by
tests/test_torch_parity.py, and compiling it under JAX would triple this
file's time.  The predictive half (covariance, samples, logpredictive, the
prior, the batched and averaged paths) is tests/test_torch_predictive.py."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx

NEWTON = dict(rtol=1e-8, atol=1e-8)  # through newton_inverse or the LOO backward


def _pair(kind, name, n=24, d=2):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((n, d))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    xs = rng.standard_normal((9, d))
    ys = np.sin(2 * xs[:, 0])
    if kind == "wgp":
        y, ys = np.exp(0.5 * y) * 10 + 1.0, np.exp(0.5 * ys) * 10 + 1.0
    out = []
    for lib in (g3, g3t):
        extra = ({} if kind == "gp"
                 else {"mapping": lib.BoxCoxLinear(y) @ lib.ArcsinhLinear(y)})
        p = (lib.GP if kind == "gp" else lib.WGP)(space=x, location=lib.Bias(),
                                                   kernel=lib.SE(x), name=name, **extra)
        p.observed(x, y)
        p.set_space(xs, hidden=ys)
        out.append(p)
    params = {k: np.asarray(v) * 1.1 for k, v in out[0].params_default.items()}
    return out[0], out[1], params, xs, ys


@pytest.mark.parametrize("kind", ["wgp"])
def test_scores_match_jax(kind):
    with floatx("float32"):
        jp, tp, params, _, _ = _pair(kind, f"SC_{kind.upper()}")
        kw = dict(logpred=True, variance=True, median=True, loo=True)
        want = {k: float(v) for k, v in jp.scores(params, **kw).items()}
        got = tp.scores(params, **kw)
        logps = tp.scores(params, logp=True, bias=False)
        assert logps == {"_logp": tp.logp(params), "_loglike": tp.loglike(params),
                         "_logprior": tp.logp(params, prior=True)}
    assert set(got) == set(want)
    assert_close(got, want)
    assert all(isinstance(v, float) for v in got.values())


@pytest.mark.parametrize("kind", ["wgp"])
def test_loo_and_its_gradient_match_jax(kind):
    with floatx("float64"):
        jp, tp, params, _, _ = _pair(kind, f"LOO_{kind.upper()}")
        u = jp.active.dict_to_array(params)
        np.testing.assert_allclose(tp.loo(params), jp.loo(params), **NEWTON)
        np.testing.assert_allclose(tp._array_loo_sampling(u), jp._array_loo_sampling(u),
                                   **NEWTON)
        np.testing.assert_allclose(tp._array_dloo_sampling(u),
                                   np.asarray(jp._array_dloo_sampling(u)), **NEWTON)


def test_find_map_loo_matches_jax():
    with floatx("float64"):
        jp, tp, params, _, _ = _pair("gp", "MAPLOO_GP")
        kw = dict(start=params, points=1, powell=False, display=False, objective="loo",
                  return_points=True)
        (jbest, jpts), (tbest, tpts) = jp.find_MAP(**kw), tp.find_MAP(**kw)
    assert [p[0] for p in tpts] == [p[0] for p in jpts] == ["start", "start_bfgs"]
    assert tpts[1][1] > tpts[0][1]
    np.testing.assert_allclose([p[1] for p in tpts], [p[1] for p in jpts], rtol=1e-8)
    for k in jbest:
        np.testing.assert_allclose(tbest[k], np.asarray(jbest[k]), rtol=1e-5, atol=1e-6)
