"""Port parity of the ensemble samplers: the stretch move, a 20-iteration
``ensemble_sampler`` and a ``pt_sampler`` against the JAX package's, on a
toy quadratic log density at float64.

The two packages draw different random numbers from the same seed, so the
JAX draws are rebuilt from the same key splits as the JAX sampler makes
them (g3py_tpu/bayesian/samplers.py) and fed to the port's draw functions;
the chains must then agree to 1e-10.  The initial ensemble of
``mcmc_ensemble`` comes from the same numpy generator in both and must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from g3py_tpu.bayesian import samplers as jsam
from g3py_tpu_torch.bayesian import samplers as tsam

from torch_parity import floatx

MU = np.array([0.5, -1.0, 2.0])
SCALE = np.array([1.0, 0.5, 2.0])


def _jlogp(p):
    return -0.5 * jnp.sum(((p - MU) / SCALE) ** 2)


def _tlogp(p):  # batched: (R, ndim) -> (R,)
    mu, s = torch.as_tensor(MU), torch.as_tensor(SCALE)
    return -0.5 * (((p - mu) / s) ** 2).sum(dim=-1)


def _jprior(p):
    return -0.05 * jnp.sum(p ** 2)


def _tprior(p):
    return -0.05 * (p ** 2).sum(dim=-1)


def _jax_half_draws(key, n, n_other):
    k1, k2, k3 = random.split(key, 3)
    return (np.asarray(random.uniform(k1, (n,), dtype=jnp.float64)),
            np.asarray(random.randint(k2, (n,), 0, n_other)),
            np.asarray(jnp.log(random.uniform(k3, (n,), dtype=jnp.float64))))


class _Feed:
    """Stands in for the port's draw functions, handing out precomputed
    draws in the order the port asks for them."""

    def __init__(self):
        self.halves, self.swaps = [], []

    def half(self, gen, shape, n_other, dtype, device):
        u, j, log_u = self.halves.pop(0)
        assert u.shape == shape
        return (torch.as_tensor(u, dtype=dtype), torch.as_tensor(j, dtype=torch.int64),
                torch.as_tensor(log_u, dtype=dtype))

    def swap(self, gen, shape, dtype, device):
        log_u = self.swaps.pop(0)
        assert log_u.shape == shape
        return torch.as_tensor(log_u, dtype=dtype)


@pytest.fixture
def feed(monkeypatch):
    f = _Feed()
    monkeypatch.setattr(tsam, "_half_draws", f.half)
    monkeypatch.setattr(tsam, "_swap_draws", f.swap)
    return f


def _walkers(seed, chains):
    return np.random.default_rng(seed).normal(size=(chains, len(MU)))


def test_stretch_half_matches_jax(feed):
    with floatx("float64"):
        x = _walkers(0, 8)
        key = random.PRNGKey(3)
        lp = np.array(jax.vmap(_jlogp)(jnp.asarray(x)))
        stretch = jax.jit(jsam._stretch_half, static_argnums=(4, 5))
        want_x, want_lp = stretch(key, jnp.asarray(x[:4]), jnp.asarray(lp[:4]),
                                  jnp.asarray(x[4:]), jax.vmap(_jlogp), 2.0)
        feed.halves.append(_jax_half_draws(key, 4, 4))
        got_x, got_lp, _ = tsam._stretch_half(
            None, torch.as_tensor(x[:4]), torch.as_tensor(lp[:4]), (), torch.as_tensor(x[4:]),
            lambda y: (_tlogp(y), ()), 2.0)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=1e-10, atol=1e-10)
    moved = (got_x.numpy() != x[:4]).any(-1)
    assert 0 < int(moved.sum()) < 4  # both branches of the acceptance test taken


def test_ensemble_sampler_matches_jax(feed):
    chains, samples, seed = 8, 20, 5
    with floatx("float64"):
        p0 = _walkers(1, chains)
        want_chain, want_lnprob = jsam.ensemble_sampler(_jlogp, p0, samples, key=seed)
        for k in random.split(random.PRNGKey(seed), samples):
            k1, k2 = random.split(k)
            feed.halves += [_jax_half_draws(k1, 4, 4), _jax_half_draws(k2, 4, 4)]
        calls = []

        def logp(u):
            calls.append(u.shape)
            return _tlogp(u)

        chain, lnprob = tsam.ensemble_sampler(logp, p0, samples, key=seed)
    assert not feed.halves
    assert calls == [(8, 3)] + [(4, 3)] * (2 * samples)  # one batched call a half
    assert chain.shape == (chains, samples, 3) and lnprob.shape == (chains, samples)
    np.testing.assert_allclose(chain, want_chain, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lnprob, want_lnprob, rtol=1e-10, atol=1e-10)
    moved = (np.diff(np.concatenate([p0[:, None], chain], axis=1), axis=1) != 0).any(-1)
    assert 0.0 < moved.mean() < 1.0  # moves accepted and rejected


def test_pt_sampler_matches_jax(feed):
    ntemps, chains, samples, seed = 3, 6, 12, 9
    with floatx("float64"):
        p0 = np.random.default_rng(2).normal(size=(ntemps, chains, len(MU)))
        want_chain, want_lnprob = jsam.pt_sampler(_jlogp, _jprior, p0, samples, key=seed)
        for k in random.split(random.PRNGKey(seed), samples):
            k_move, k_swap = random.split(k)
            halves = [[], []]
            for kt in random.split(k_move, ntemps):
                for h, kh in enumerate(random.split(kt)):
                    halves[h].append(_jax_half_draws(kh, 3, 3))
            feed.halves += [tuple(np.stack(d) for d in zip(*h)) for h in halves]
            feed.swaps.append(np.stack([
                np.asarray(jnp.log(random.uniform(ks, (chains,), dtype=jnp.float64)))
                for ks in random.split(k_swap, ntemps - 1)]))
        chain, lnprob = tsam.pt_sampler(_tlogp, _tprior, p0, samples, key=seed)
    assert not feed.halves and not feed.swaps
    np.testing.assert_allclose(chain, want_chain, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lnprob, want_lnprob, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("ntemps", [None, 3])
@pytest.mark.parametrize("start_kind", ["point", "ensemble"])
def test_mcmc_ensemble_start_matches_jax(monkeypatch, ntemps, start_kind):
    """The jittered initial ensemble is the JAX package's, draw for draw."""
    ndim, chains = 3, 7  # odd: both round it up to 8
    start = np.array([0.0, 1.5, -2.0])
    if start_kind == "ensemble":
        start = np.random.default_rng(4).normal(size=(8, ndim))
        start[2, 0] = 0.0
    seen = {}

    def capture(pkg):
        def sampler(*args, **kwargs):
            p0 = args[2] if ntemps is not None else args[1]
            seen[pkg] = np.asarray(p0)
            shape = p0.shape[-2:]
            return np.zeros((shape[0], 1, shape[1])), np.zeros((shape[0], 1))
        return sampler

    name = "ensemble_sampler" if ntemps is None else "pt_sampler"
    monkeypatch.setattr(jsam, name, capture("jax"))
    monkeypatch.setattr(tsam, name, capture("torch"))
    kw = dict(samples=1, chains=chains, ntemps=ntemps, start=start, seed=11)
    jsam.mcmc_ensemble(ndim, **kw)
    tsam.mcmc_ensemble(ndim, **kw)
    assert seen["torch"].shape == ((8, ndim) if ntemps is None else (3, 8, ndim))
    np.testing.assert_array_equal(seen["torch"], seen["jax"])


def test_chains_must_be_even():
    with pytest.raises(ValueError, match="even"):
        tsam.ensemble_sampler(_tlogp, np.zeros((5, 3)), 2)


def test_hmc_sampler_matches_jax(monkeypatch):
    """Batched HMC fed the JAX package's draws (its per-chain key splits):
    every leapfrog step one batched value-and-gradient call of all
    chains."""
    chains, samples, steps, seed = 3, 12, 4, 2
    with floatx("float64"):
        p0 = _walkers(6, chains)
        want_chain, want_lnprob = jsam.hmc_sampler(_jlogp, p0, samples, key=seed,
                                                   step_size=0.6, leapfrog_steps=steps)
        draws = [[random.split(k) for k in random.split(kc, samples)]
                 for kc in random.split(random.PRNGKey(seed), chains)]

        def hmc_draws(gen, shape, dtype, device):
            pairs = [d.pop(0) for d in draws]
            p = np.stack([np.asarray(random.normal(k1, shape[1:], dtype=jnp.float64))
                          for k1, _ in pairs])
            u = np.array([float(random.uniform(k2, dtype=jnp.float64)) for _, k2 in pairs])
            return torch.as_tensor(p), torch.as_tensor(u)

        monkeypatch.setattr(tsam, "_hmc_draws", hmc_draws)
        calls0 = tsam.value_and_grad.calls
        chain, lnprob = tsam.hmc_sampler(_tlogp, p0, samples, key=seed, step_size=0.6,
                                         leapfrog_steps=steps)
    assert tsam.value_and_grad.calls - calls0 == 1 + samples * steps
    np.testing.assert_allclose(chain, np.asarray(want_chain), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lnprob, np.asarray(want_lnprob), rtol=1e-10, atol=1e-10)
    moved = (np.diff(chain, axis=1) != 0).any(-1)
    assert 0.0 < moved.mean() < 1.0  # moves accepted and rejected
