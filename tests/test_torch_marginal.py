"""Port parity of the marginal family (MP) and of the special functions
behind it and the copulas: every Density's logp, cdf and ppf, the MP
statistics and draws, and ``betainc`` (value, x-gradient, the JAX
package's ``ValueError`` for a gradient in a or b) and ``ndtri``.

Tolerances: float64 against JAX x64 at rtol/atol 1e-10, float32 at rtol
1e-4 / atol 1e-5 (``torch_parity``)."""

import jax
import jax.numpy as jnp
import jax.scipy.special as jss
import numpy as np
import pytest
import scipy.special
import torch
from scipy import stats

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.ops import special

from torch_parity import assert_close, check, floatx

NAMES = ["float32", "float64"]
PARAMS = {"t": {"MPD_M_Bias": 0.1, "MPD_S_Bias": 1.2, "MPD_N_Bias": 5.0},
          "normal": {"MPD_M_Bias": 0.1, "MPD_S_Bias": 1.2},
          "uniform": {"MPD_L_Bias": -6.0, "MPD_U_Bias": 7.0}}


def _data(n=30, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 10, n).astype(np.float32).reshape(-1, 1)
    return x, rng.standard_t(5, n).astype(np.float32)


def _density(g, kind, x):
    if kind == "t":
        return g.StudentT(mu=g.Bias(x, name="M"), sigma=g.Bias(x, name="S"),
                          nu=g.Bias(x, name="N"))
    if kind == "normal":
        return g.Normal(mu=g.Bias(x, name="M"), sigma=g.Bias(x, name="S"))
    return g.Uniform(lower=g.Bias(x, name="L"), upper=g.Bias(x, name="U"))


def _pair(kind):
    x, y = _data()
    jp = g3.MP(space=x, density=_density(g3, kind, x), name="MPD")
    tp = g3t.MP(space=x, density=_density(g3t, kind, x), name="MPD")
    jp.observed(x, y)
    tp.observed(x, y)
    return jp, tp, x, y


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["t", "normal", "uniform"])
def test_density_and_statistics(kind, name):
    with floatx(name):
        jp, tp, x, y = _pair(kind)
        assert list(tp.active.params_spec) == list(jp.active.params_spec)
        params = {k: np.asarray(v, name) for k, v in PARAMS[kind].items()}
        assert_close(tp.logp(params), np.asarray(jp.logp(params)), name)
        u = jp.active.dict_to_array(params)
        if kind != "uniform":  # the uniform's logp is flat inside its support
            assert_close(tp.dlogp(u), np.asarray(jp.dlogp(u)), name)
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        tparams = {k: torch.as_tensor(v) for k, v in params.items()}
        jd, td = jp.f_density, tp.f_density
        xs, ys = x.astype(name), y.astype(name)
        assert_close(td.cdf(tparams, torch.as_tensor(xs), torch.as_tensor(ys)),
                     np.asarray(jd.cdf(jparams, jnp.asarray(xs), jnp.asarray(ys))), name)
        q = np.linspace(0.05, 0.95, len(x))
        assert_close(td.ppf(tparams, torch.as_tensor(xs), q), jd.ppf(params, xs, q), name)
        flags = dict(quantiles=True, var=True, cov=True, median=True)
        want = {k: np.asarray(v) for k, v in jp.predict(params, **flags).items()}
        assert_close(tp.predict(params, **flags), want, name)
        assert_close(tp.logpredictive(params, vector=y), np.asarray(
            jp.logpredictive(params, vector=y)), name)


def test_scipy_reference_and_draws():
    """The StudentT density against ``scipy.stats.t`` (the JAX package's own
    check, tests/test_models.py), and the draws from numpy's global
    generator, seeded alike for both packages."""
    jp, tp, x, y = _pair("t")
    params = {k: np.float32(v) for k, v in PARAMS["t"].items()}
    want = stats.t.logpdf(y, 5.0, loc=0.1, scale=1.2).sum()
    np.testing.assert_allclose(tp.logp(params), want, rtol=1e-5)
    for kind in ("t", "normal", "uniform"):
        jp, tp, x, y = _pair(kind)
        params = {k: np.float32(v) for k, v in PARAMS[kind].items()}
        np.random.seed(5)
        want = jp.sampler(params, samples=3)
        np.random.seed(5)
        got = tp.sampler(params, samples=3)
        assert got.shape == (len(x), 3)
        assert_close(got, np.asarray(want))
    jp, tp, x, y = _pair("t")
    np.testing.assert_array_equal(tp.freedom(PARAMS["t"]), np.full(len(x), 5.0))


def test_rows_evaluate_one_at_a_time():
    """MP has no row axis: ``logp_chain`` evaluates each row on its own."""
    with floatx("float64"):
        jp, tp, x, y = _pair("t")
        u0 = jp.active.dict_to_array({k: np.asarray(v) for k, v in PARAMS["t"].items()})
        rows = u0[None] + 0.1 * np.random.default_rng(3).standard_normal((4, len(u0)))
        assert_close(tp.logp_chain(rows), np.asarray(jp.logp_chain(rows)), "float64")


@pytest.mark.parametrize("name", NAMES)
def test_betainc_value_and_x_gradient(name):
    rng = np.random.default_rng(1)
    a = rng.uniform(0.1, 40.0, 64)
    b = rng.uniform(0.1, 6.0, 64)
    x = rng.uniform(0.0, 1.0, 64)
    check(jss.betainc, special.betainc, a, b, x, name=name)
    with floatx(name):
        want = jax.grad(lambda xx: jss.betainc(jnp.asarray(a, name), jnp.asarray(b, name),
                                               xx).sum())(jnp.asarray(x, name))
        xt = torch.as_tensor(x.astype(name)).requires_grad_(True)
        (got,) = torch.autograd.grad(special.betainc(torch.as_tensor(a.astype(name)),
                                                     torch.as_tensor(b.astype(name)),
                                                     xt).sum(), xt)
        assert_close(got, np.asarray(want), name)
    np.testing.assert_allclose(special.betainc(torch.as_tensor(a), torch.as_tensor(b),
                                               torch.as_tensor(x)).numpy(),
                               scipy.special.betainc(a, b, x),
                               rtol=1e-12, atol=1e-13)


def test_betainc_edges_and_a_b_gradient_raises():
    a = np.array([0.0, 2.0, 2.0, 2.0, -1.0, 3.0])
    b = np.array([1.0, 0.0, 3.0, 3.0, 1.0, np.inf])
    x = np.array([0.5, 0.5, 0.0, 1.0, 0.5, 0.2])
    check(jss.betainc, special.betainc, a, b, x, name="float64")
    at = torch.tensor([2.5, 4.0], dtype=torch.float64, requires_grad=True)
    out = special.betainc(at, torch.tensor([0.5, 0.5], dtype=torch.float64),
                          torch.tensor([0.3, 0.7], dtype=torch.float64))
    with pytest.raises(ValueError, match="Betainc gradient with respect to a and b"):
        torch.autograd.grad(out.sum(), at)
    with pytest.raises(ValueError, match="Betainc gradient with respect to a and b"):
        jax.grad(lambda aa: jss.betainc(aa, 0.5, 0.3))(2.5)


@pytest.mark.parametrize("name", NAMES)
def test_ndtri_ndtr_gammaln(name):
    p = np.concatenate([np.linspace(1e-6, 1 - 1e-6, 33), [1e-12, 0.5]])
    check(jss.ndtri, special.ndtri, p, name=name)
    z = np.linspace(-8.0, 8.0, 41)
    check(jss.ndtr, special.ndtr, z, name=name)
    check(jss.gammaln, special.gammaln, np.linspace(0.1, 50.0, 37), name=name)
    check(lambda v: jax.scipy.stats.norm.cdf(v, 0.3, 1.7),
          lambda v: special.norm_cdf(v, 0.3, 1.7), z, name=name)
