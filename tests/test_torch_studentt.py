"""Port parity of the Student-t family (TP / WTP) with the JAX package:
logp, dlogp, every ``predict`` statistic, logpredictive, the factored
``Predictor``, the multivariate-t density and the sampler with the same
numpy draws (the batched rows and ``find_MAP`` are
tests/test_torch_studentt_rows.py's).

Tolerances: float64 against JAX x64 at rtol/atol 1e-10, float32 at rtol
1e-4 / atol 1e-5 (``torch_parity``); the Predictor against the port's own
``predict`` at 2e-4 (the JAX package's own test of its Predictor,
tests/test_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.models.studentt import warped_studentt_logp_cho

from torch_parity import assert_close, floatx, to_numpy

NAMES = ["float32", "float64"]
STATS = dict(quantiles=True, quantiles_noise=True, var=True, median=True)


def _data(n=28, d=2, seed=3, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    if positive:
        y = (np.exp(0.3 * y) + 1.0).astype(np.float32)
    return x, y


def _pair(family, name, x, y):
    if family == "TP":
        kw = lambda g: dict(location=g.Bias(), kernel=g.SE(x))  # noqa: E731
    else:
        kw = lambda g: dict(location=g.Bias(), kernel=g.MAT52(x),  # noqa: E731
                            mapping=g.BoxCoxLinear(y))
    jp = getattr(g3, family)(space=x, name=name, **kw(g3))
    tp = getattr(g3t, family)(space=x, name=name, **kw(g3t))
    jp.observed(x, y)
    tp.observed(x, y)
    return jp, tp


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("family", ["TP", "WTP"])
def test_logp_dlogp_and_statistics(family, name):
    """logp, dlogp and every statistic of ``predict`` and of the factored
    Predictor against the JAX package's Predictor (its fused form of the
    same statistics, one compile); in float64 ``predict`` of the port too,
    and the prior's statistics."""
    with floatx(name):
        x, y = _data(positive=family == "WTP")
        jp, tp = _pair(family, f"ST_{family}", x, y)
        params = dict(jp.params_default)
        u = jp.active.dict_to_array(params)
        assert list(tp.active.params_spec) == list(jp.active.params_spec)
        assert_close(tp.logp(params), np.asarray(jp.logp(params)), name)
        assert_close(tp.dlogp(u), np.asarray(jp.dlogp(u)), name)
        xq = np.linspace(-2, 2, 9, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
        flags = dict(STATS, cov=family == "TP")
        want = {k: np.asarray(v) for k, v in jp.predictor(params)(xq, **flags).items()}
        assert_close(tp.predictor(params)(xq, **flags), want, name)
        if name == "float64":
            assert_close(tp.predict(params, space=xq, **flags), want, name)
            prior = {k: np.asarray(v) for k, v in jp.predictor(params)(
                xq, prior=True, var=True).items()}
            assert_close(tp.predict(params, space=xq, prior=True, var=True), prior, name)


@pytest.mark.parametrize("family", ["TP", "WTP"])
def test_predictor_matches_predict(family):
    """The factored Predictor against the port's ``predict`` at 2e-4 (the
    JAX package's own test of its TP Predictor, tests/test_models.py), and
    its logpredictive against the JAX package's."""
    with floatx("float64"):
        x, y = _data(positive=family == "WTP")
        jp, tp = _pair(family, f"STP_{family}", x, y)
        params = jp.params_default
        xq = np.linspace(-1, 1, 7, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
        cov = family == "TP"
        base = tp.predict(params, space=xq, cov=cov, **STATS)
        pr = tp.predictor(params)
        fast = pr(xq, cov=cov, **STATS)
        assert set(base) == set(fast)
        for k in base:
            np.testing.assert_allclose(to_numpy(fast[k]), to_numpy(base[k]), rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        assert_close(pr.logpredictive(y[:5], x[:5]),
                     np.asarray(jp.logpredictive(params, space=x[:5], vector=y[:5],
                                                 noise=True)), "float64")


def test_sampler_same_draws():
    """The sampler with the same numpy draws: the normals from one seeded
    Generator, the inverse-gamma mixing from numpy's global generator,
    seeded alike for both packages."""
    with floatx("float64"):
        x, y = _data()
        jp, tp = _pair("TP", "STS_TP", x, y)
        params = jp.params_default
        xq = x[:6] + 0.05
        np.random.seed(17)
        want = jp.sampler(params, space=xq, samples=5, rng=np.random.default_rng(4))
        np.random.seed(17)
        got = tp.sampler(params, space=xq, samples=5, rng=np.random.default_rng(4))
        assert got.shape == (6, 5)
        assert_close(got, np.asarray(want), "float64")
        rows = tp.active.dict_to_array(params)[None] * np.ones((3, 1))
        assert_close(tp._batch_quantile_p(0.9, rows), jp._batch_quantile_p(0.9, rows),
                     "float64")
        assert_close(tp._batch_latent_rand(rows, 4, np.random.default_rng(8)),
                     jp._batch_latent_rand(rows, 4, np.random.default_rng(8)), "float64")


@pytest.mark.parametrize("name", NAMES)
def test_warped_studentt_logp_cho(name):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((6, 6))
    cho = np.linalg.cholesky(a @ a.T + 6 * np.eye(6))
    value, mu = rng.standard_normal(6), rng.standard_normal(6)
    args = (value, mu, cho, np.array(7.5), value * 1.1, np.array(0.3))
    jfn = jax.jit(g3.models.studentt.warped_studentt_logp_cho)
    with floatx(name):
        for nu in (7.5, 2e6):  # 2e6: the gaussian limit
            ins = [np.asarray(a, name) for a in args[:3] + (np.array(nu),) + args[4:]]
            assert_close(warped_studentt_logp_cho(*[torch.as_tensor(a) for a in ins]),
                         np.asarray(jfn(*[jnp.asarray(a) for a in ins])), name)


def test_degree_is_registered():
    """``EllipticalProcess(degree=Freedom())`` registers the degree after the
    location, kernel and mapping, and ``freedom`` is nu + n (nu on the
    prior)."""
    x, y = _data(n=10)
    ep = g3t.EllipticalProcess(space=x, location=g3t.Bias(), kernel=g3t.SE(x),
                               degree=g3t.Freedom(), name="EPD")
    ep.observed(x, y)
    assert list(ep.active.params_spec)[-1] == "EPD_Freedom_degree"
    params = ep.params_default
    assert float(params["EPD_Freedom_degree"]) == 10.0
    assert float(ep.freedom(params)) == 22.0
    assert float(ep.freedom(params, prior=True)) == 12.0
