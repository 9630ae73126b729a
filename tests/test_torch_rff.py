"""Port parity of ``ops/rff.py``: the spectral frequencies, the feature map
and the prior paths of every family (SE, MAT32, MAT52, RQ) against the JAX
package's from the JAX package's own draws (rebuilt from its key splits
and fed to the port's transform), the port's own draws (seeded
``torch.Generator``: reproducible, the gamma sampler's moments), and the
feature gram against the kernel gram at many features (as the JAX
package's ``TestSpectralRFF``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from g3py_tpu.ops import rff as jrff
from g3py_tpu_torch.ops import rff as trff
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx

FAMILIES = [("se", None, None), ("mat32", 1.5, None), ("mat52", 2.5, None), ("rq", None, 1.3)]


def jax_draws(key, ndim, n_features, n_paths=None, nu=None, rq_alpha=None):
    """The draws the JAX package takes from ``key`` in ``rff_prior_fn``
    (with ``n_paths``) or ``spectral_rff``, as numpy."""
    from g3py_tpu.config import settings as jset

    dt = jset.dtype
    if n_paths is not None:
        key, k_theta = random.split(key)
    kw, kb = random.split(key)
    kz, ku = random.split(kw)
    out = {"z": random.normal(kz, (n_features, ndim), dtype=dt),
           "b": random.uniform(kb, (n_features,), dtype=dt, maxval=2.0 * np.pi)}
    if rq_alpha is not None:
        out["gamma"] = random.gamma(ku, jnp.asarray(rq_alpha, dt), (n_features,), dtype=dt)
    elif nu is not None:
        out["gamma"] = random.gamma(ku, jnp.asarray(nu, dt), (n_features,), dtype=dt)
    if n_paths is not None:
        out["theta"] = random.normal(k_theta, (n_features, n_paths), dtype=dt)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", ["float64", "float32"])
@pytest.mark.parametrize("family,nu,alpha", FAMILIES)
def test_features_and_paths_from_jax_draws(family, nu, alpha, name):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 3))
    rates, var = np.array([0.8, 1.4, 0.5]), 1.7
    key = random.PRNGKey(3)
    with floatx(name):
        xa, ra = x.astype(name), rates.astype(name)
        draws = jax_draws(random.split(key)[0], 3, 64, nu=nu, rq_alpha=alpha)
        want_w = jrff._frequencies(random.split(random.split(key)[0])[0], 3, 64, ra, nu=nu,
                                   rq_alpha=alpha)
        got_w = trff._frequencies({k: torch.as_tensor(np.array(v)) for k, v in draws.items()}, 3,
                                  torch.as_tensor(ra), nu=nu, rq_alpha=alpha)
        assert_close(got_w, want_w, name)
        phi_j = jrff.spectral_rff(random.split(key)[0], 3, 64, ra, var, nu=nu, rq_alpha=alpha)
        phi_t = trff.spectral_rff(draws, 3, 64, torch.as_tensor(ra), var, nu=nu,
                                  rq_alpha=alpha)
        assert_close(phi_t(torch.as_tensor(xa)), phi_j(xa), name)
        pdraws = jax_draws(key, 3, 64, n_paths=5, nu=nu, rq_alpha=alpha)
        prior_j = jrff.rff_prior_fn(key, 3, 64, ra, var, 5, nu=nu, rq_alpha=alpha)
        prior_t = trff.rff_prior_fn(pdraws, 3, 64, torch.as_tensor(ra), var, 5, nu=nu,
                                    rq_alpha=alpha)
        assert_close(prior_t(torch.as_tensor(xa)), prior_j(xa), name)


def test_se_alias_and_seeded_draws():
    """``se_spectral_rff`` is the SE map; a seed gives the same draws every
    time and a ``torch.Generator`` advances; the gamma draws have the
    gamma's mean and variance (shape < 1 through the boost too)."""
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((6, 2)), dtype=torch.float32)
    a = trff.se_spectral_rff(7, 2, 32, torch.tensor([1.0, 2.0]), 1.0)(x)
    b = trff.spectral_rff(7, 2, 32, torch.tensor([1.0, 2.0]), 1.0)(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(0)
    d1, d2 = trff.draw_rff(gen, 2, 8, 3), trff.draw_rff(gen, 2, 8, 3)
    assert not torch.equal(d1["z"], d2["z"]) and d1["theta"].shape == (8, 3)
    with floatx("float64"):
        for shape in (0.4, 1.5, 2.5):
            g = trff.standard_gamma(torch.Generator().manual_seed(1), shape, (40000,))
            assert torch.all(g > 0)
            assert abs(float(g.mean()) - shape) < 0.03 * max(shape, 1)
            assert abs(float(g.var()) - shape) < 0.06 * max(shape, 1)


@pytest.mark.parametrize("family,nu,alpha", FAMILIES)
def test_rff_gram_matches_kernels(family, nu, alpha):
    """The feature gram converges to the kernel gram (O(1/sqrt(F))), the
    JAX package's bound at F = 16384 over three seeds."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((50, 2)).astype(np.float32)
    rates = torch.tensor([0.8, 1.4])
    var = 1.7
    cls = {"se": g3t.SE, "mat32": g3t.MAT32, "mat52": g3t.MAT52, "rq": g3t.RQ}[family]
    k = cls(x)
    k.check_dims(x)
    k.check_hypers("R_")
    params = {}
    for p in k.hypers:
        if p.name.endswith("_var"):
            params[p.name] = torch.tensor(var)
        elif p.name.endswith("_alpha"):
            params[p.name] = torch.tensor(alpha)
        else:
            params[p.name] = rates
    gram = k.cov(params, torch.as_tensor(x)).numpy()
    errs = []
    for seed in range(3):
        feats = trff.spectral_rff(seed, 2, 16384, rates, var, nu=nu, rq_alpha=alpha)(
            torch.as_tensor(x)).numpy()
        errs.append(np.max(np.abs(feats @ feats.T - gram)))
    assert np.mean(errs) < 0.08 * var, (family, errs)


def test_jax_draws_helper_is_the_jax_split():
    """The helper above replays ``rff_prior_fn``'s key splits exactly: the
    JAX package's prior paths from those draws equal its own."""
    key = random.PRNGKey(5)
    d = jax_draws(key, 2, 16, n_paths=2)
    phi = np.sqrt(2.0 * 1.0 / 16) * np.cos(np.ones((3, 2)) @ d["z"].T + d["b"])
    want = np.asarray(jrff.rff_prior_fn(key, 2, 16, np.ones(2, np.float32), 1.0, 2)(
        jnp.ones((3, 2))))
    np.testing.assert_allclose(phi @ d["theta"], want, rtol=1e-5, atol=1e-5)
