"""Port parity of the observation likelihoods (``models/likelihoods.py``)
against the JAX package: every likelihood's ``logp_elem``,
``expected_logp`` (Gauss-Hermite or analytic), ``predictive_moments``,
``noise_var`` and ``check_targets``, the class probabilities of the
ordinal and categorical likelihoods, the heteroscedastic noise field,
``sample_conditional`` from the same numpy Generator, and the tails of
``log_ndtr`` in float64 (torch's is the accurate one in the upper tail).
float64 against JAX x64 at 1e-10, float32 at rtol 1e-4 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as ss
import torch
from jax.scipy.special import log_ndtr as jax_log_ndtr

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.models.likelihoods import sample_conditional as t_sample
from g3py_tpu.models.likelihoods import sample_conditional as j_sample

from torch_parity import assert_close, floatx


def _build(lib, kind):
    """A likelihood of ``kind`` in ``lib`` with its hypers registered, its
    params and observed targets."""
    rng = np.random.default_rng(3)
    n = 40
    lik = {"gauss": lambda: lib.GaussianLik(),
           "studentt": lambda: lib.StudentTLik(),
           "poisson": lambda: lib.PoissonLik(),
           "negbin": lambda: lib.NegBinomialLik(),
           "bernoulli": lambda: lib.BernoulliLik(),
           "ordinal": lambda: lib.OrdinalLik(4),
           "hetero": lambda: lib.HeteroscedasticLik(),
           "categorical": lambda: lib.CategoricalLik(3)}[kind]()
    lik.check_hypers("L_")
    if kind in ("poisson", "negbin"):
        y = rng.poisson(3.0, n).astype(float)
    elif kind == "bernoulli":
        y = (rng.uniform(size=n) < 0.4).astype(float)
    elif kind == "ordinal":
        y = rng.integers(0, 4, n).astype(float)
    elif kind == "categorical":
        y = rng.integers(0, 3, n).astype(float)
    else:
        y = rng.standard_normal(n)
    params = {k.name if hasattr(k, "name") else k: np.asarray(v, np.float64)
              for k, v in lik.default_hypers(None, y).items()}
    # off the defaults: a log-spacing, a cut and a bias that are not 0
    for k in params:
        params[k] = params[k] * 1.3 + 0.2
    heads = {"hetero": 2, "categorical": 3}.get(kind)
    shape = (n,) if heads is None else (n, heads)
    mu = 0.8 * rng.standard_normal(shape)
    var = rng.uniform(0.05, 1.5, shape)
    return lik, params, y, mu, var


KINDS = ["gauss", "studentt", "poisson", "negbin", "bernoulli", "ordinal", "hetero",
         "categorical"]


def _as(lib, params, name):
    if lib is g3:
        return {k: jnp.asarray(v, name) for k, v in params.items()}
    return {k: torch.as_tensor(np.asarray(v, name)) for k, v in params.items()}


def _quantities(lik, p, y_, mu_, var_):
    """Every elementwise quantity of ``lik`` (the latent ``mu_`` as f)."""
    out = {"logp_elem": lik.logp_elem(p, y_, mu_),
           "expected_logp": lik.expected_logp(p, y_, mu_, var_),
           "predictive_moments": lik.predictive_moments(p, mu_, var_),
           "noise_var": lik.noise_var(p)}
    if mu_.ndim == 1:
        out["cond_mean"] = lik.cond_mean(p, mu_)
        out["cond_var"] = lik.cond_var(p, mu_)
    if hasattr(lik, "probs"):
        out["probs"] = lik.probs(p, mu_, var_)
    if hasattr(lik, "log_predictive"):
        out["log_predictive"] = lik.log_predictive(p, y_, mu_, var_)
    if hasattr(lik, "noise_mean"):
        out["noise_mean"] = lik.noise_mean(p, mu_, var_)
    return out


def _moments(lib, lik, params, y, mu, var, name):
    """:func:`_quantities` in ``lib`` as numpy; the JAX package's through
    one jit of them all (a fraction of the time of dispatching them op by
    op)."""
    p = _as(lib, params, name)
    arr = jnp.asarray if lib is g3 else torch.as_tensor
    args = [arr(np.asarray(t, name)) for t in (y, mu, var)]
    if lib is g3:
        out = jax.jit(lambda p_, *a: _quantities(lik, p_, *a))(p, *args)
    else:
        out = _quantities(lik, p, *args)
    return {k: tuple(np.asarray(t) for t in v) if isinstance(v, tuple) else np.asarray(v)
            for k, v in out.items() if v is not None}


@pytest.mark.parametrize("name", ["float64", "float32"])
@pytest.mark.parametrize("kind", KINDS)
def test_likelihood_matches_jax(kind, name):
    with floatx(name):
        jl, params, y, mu, var = _build(g3, kind)
        tl = _build(g3t, kind)[0]
        assert [h.name for h in tl.hypers] == [h.name for h in jl.hypers]
        want = _moments(g3, jl, params, y, mu, var, name)
        got = _moments(g3t, tl, params, y, mu, var, name)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], name, err_msg=f"{kind} {k}")


@pytest.mark.parametrize("kind", KINDS)
def test_check_targets_and_latent_guess_match(kind):
    jl, _, y, _, _ = _build(g3, kind)
    tl = _build(g3t, kind)[0]
    for bad in (y + 0.5, y - 10.0, 2 * y - 1):
        try:
            jl.check_targets(bad)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                tl.check_targets(bad)
        else:
            tl.check_targets(bad)
    np.testing.assert_array_equal(tl.latent_guess(y), jl.latent_guess(y))


@pytest.mark.parametrize("kind", ["gauss", "studentt", "poisson", "negbin", "bernoulli",
                                  "ordinal"])
def test_sample_conditional_matches_jax(kind):
    """The same numpy Generator gives the same draws (the port's params as
    tensors, the JAX package's as arrays)."""
    with floatx("float64"):
        jl, params, _, mu, _ = _build(g3, kind)
        tl = _build(g3t, kind)[0]
        f = np.stack([mu, mu + 0.3], axis=1)
        want = j_sample(jl, params, f, np.random.default_rng(5))
        got = t_sample(tl, _as(g3t, params, "float64"), f, np.random.default_rng(5))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="no conditional sampler"):
        t_sample(_build(g3t, "hetero")[0], {}, f, np.random.default_rng(0))


def test_log_ndtr_tails_float64():
    """torch's log_ndtr agrees with scipy's to 1e-11 over [-1e4, 40] (to
    1e-300 absolute where the value is subnormal); the
    JAX package's (jax.scipy) agrees with both to 1e-10 below 5 and loses
    accuracy in the upper tail (5, 8), where log Phi(x) ~ -Phi(-x) ~ 1e-7 to
    1e-15: up to ~4e-3 relative there (the port's value is scipy's)."""
    x = np.concatenate([-np.logspace(-3, 4, 200), np.logspace(-3, 1.6, 200), [0.0]])
    ref = ss.log_ndtr(x)
    with floatx("float64"):
        want = np.asarray(jax_log_ndtr(jnp.asarray(x)))
    got = torch.special.log_ndtr(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-300)
    low = x < 5.0
    np.testing.assert_allclose(got[low], want[low], rtol=1e-9, atol=0)
    upper = (x > 5.0) & (x < 8.0)
    jax_err = np.abs(want[upper] - ref[upper]) / np.abs(ref[upper])
    port_err = np.abs(got[upper] - ref[upper]) / np.abs(ref[upper])
    assert port_err.max() < 1e-12 < 1e-4 < jax_err.max()
    # the Bernoulli likelihood reads it through torch
    lik = g3t.BernoulliLik()
    with floatx("float64"):
        lp = lik.logp_elem({}, torch.ones(len(x), dtype=torch.float64), torch.as_tensor(x))
    np.testing.assert_allclose(lp.numpy(), ref, rtol=1e-11, atol=1e-300)


def test_gauss_hermite_degree_and_constants():
    """The quadrature path (StudentT) at degree 20 with the float32-rounded
    sqrt 2 and sqrt pi of the JAX package: a StudentT expected log-lik at
    nu -> large tends to the gaussian's analytic one."""
    with floatx("float64"):
        t = g3t.StudentTLik(var=0.3, nu=1e6)
        g = g3t.GaussianLik(var=0.3)
        mu = torch.linspace(-1, 1, 7, dtype=torch.float64)
        var = torch.full((7,), 0.2, dtype=torch.float64)
        y = torch.linspace(-0.5, 0.5, 7, dtype=torch.float64)
        np.testing.assert_allclose(t.expected_logp({}, y, mu, var).numpy(),
                                   g.expected_logp({}, y, mu, var).numpy(), rtol=1e-5)
    assert g3t.Likelihood.degree == g3.Likelihood.degree == 20
    assert g3t.CategoricalLik.mc == g3.CategoricalLik.mc


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_ndtr_keeps_both_tails(name):
    """``ops.special.ndtr`` (the probit likelihoods, ``norm_cdf``) is the JAX
    package's two-tailed form: scipy's values at 1e-13 (float64) / 5e-5
    (float32, erfc's own accuracy far in the tail) relative down to x = -37
    (-12 in float32), and the JAX package's at 1e-12 / 5e-5, where
    ``torch.special.ndtr``'s 1 + erf loses the lower tail."""
    from g3py_tpu_torch.ops.special import ndtr, norm_cdf
    from jax.scipy.special import ndtr as jax_ndtr

    lo = -37.0 if name == "float64" else -12.0
    x = np.linspace(lo, 9.0, 1001).astype(name)
    ref = ss.ndtr(x.astype(np.float64))
    got = ndtr(torch.as_tensor(x)).numpy()
    rtol = 1e-13 if name == "float64" else 5e-5
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
    with floatx(name):
        want = np.asarray(jax_ndtr(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12 if name == "float64" else 5e-5, atol=0)
    np.testing.assert_allclose(norm_cdf(torch.as_tensor(x), 1.0, 2.0).numpy(),
                               ss.ndtr((x.astype(np.float64) - 1.0) / 2.0), rtol=rtol)
    assert torch.special.ndtr(torch.as_tensor(x))[0] == 0.0 < ref[0]
