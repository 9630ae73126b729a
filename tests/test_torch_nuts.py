"""Port parity of the No-U-Turn sampler (g3py_tpu_torch/bayesian/nuts.py)
against the JAX package's at float64: the pieces (``_leapfrog``,
``_uturn``, ``_draw_momentum`` diagonal and dense, one dual-averaging
update, ``_mass_from_var`` with its diagonal fallback) to 1e-12, then one
``_nuts_step`` on a correlated 3-d gaussian and on a GP(Bias, SE) with
n=16, and a short ``nuts_sampler(chunk=None)`` with diagonal and dense mass
to 1e-10.

The two packages draw different random numbers, so the JAX draws are rebuilt
from the JAX sampler's own key splits (g3py_tpu/bayesian/nuts.py) and fed to
the port's draw functions (:class:`NutsFeed`), a chain at a time: the
momentum normals of each step, the direction bit and swap uniform of each
doubling and the selection uniform of each leaf.  The port runs its chains
in lockstep with masks, as ``vmap`` does; a draw it asks for a chain that
has stopped is handed out and masked away.  (The statistical assertions
of tests/test_samplers.py's ``TestNUTS`` run on the port in
tests/test_torch_sampler_stats.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from g3py_tpu.bayesian import nuts as jnuts
from g3py_tpu_torch.bayesian import nuts as tnuts
from g3py_tpu_torch.bayesian import samplers as tsam

from torch_parity import floatx, process_pair

COV3 = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.3], [0.2, -0.3, 0.5]])
TIGHT = dict(rtol=1e-12, atol=1e-12)
CHAIN = dict(rtol=1e-10, atol=1e-10)


def _gauss(cov):
    prec = np.linalg.inv(cov)

    def jlogp(p):
        return -0.5 * p @ jnp.asarray(prec) @ p

    def tlogp(p):  # batched: (R, ndim) -> (R,)
        return -0.5 * ((p @ torch.as_tensor(prec)) * p).sum(-1)

    return jlogp, tlogp


class NutsFeed:
    """Stands in for the port's NUTS draw functions: each chain follows the
    JAX sampler's key splits from its list of step keys."""

    def __init__(self, step_keys):
        self.steps = [list(k) for k in step_keys]
        n = len(self.steps)
        self.tree, self.leaf, self.swapk = [None] * n, [None] * n, [None] * n

    def install(self, monkeypatch):
        for name in ("momentum", "direction", "select", "swap"):
            monkeypatch.setattr(tnuts, f"_{name}_draws", getattr(self, name))

    def momentum(self, gen, shape, dtype, device):
        out = []
        for c in range(shape[0]):
            k_mom, self.tree[c] = random.split(self.steps[c].pop(0))
            out.append(np.asarray(random.normal(k_mom, shape[1:], dtype=jnp.float64)))
        return torch.as_tensor(np.stack(out), dtype=dtype)

    def direction(self, gen, shape, device):
        out = []
        for c in range(shape[0]):
            self.tree[c], k_dir, self.leaf[c], self.swapk[c] = random.split(self.tree[c], 4)
            out.append(bool(random.bernoulli(k_dir)))
        return torch.as_tensor(out)

    def select(self, gen, shape, dtype, device):
        out = []
        for c in range(shape[0]):
            self.leaf[c], k_sel = random.split(self.leaf[c])
            out.append(float(random.uniform(k_sel, dtype=jnp.float64)))
        return torch.as_tensor(out, dtype=dtype)

    def swap(self, gen, shape, dtype, device):
        return torch.as_tensor([float(random.uniform(k, dtype=jnp.float64))
                                for k in self.swapk[:shape[0]]], dtype=dtype)


def _sampler_keys(seed, chains, warmup, samples, adapt_mass):
    """Each chain's step keys in the order the monolithic JAX sampler uses
    them: warmup phase 1, phase 2, then the samples."""
    k_warm, k_run = random.split(random.PRNGKey(seed))
    n1 = warmup // 2 if adapt_mass else warmup
    out = []
    for wk, rk in zip(random.split(k_warm, chains), random.split(k_run, chains)):
        k1, k2 = random.split(wk)
        keys = list(random.split(k1, n1))
        if adapt_mass:
            keys += list(random.split(k2, warmup - n1))
        out.append(keys + list(random.split(rk, samples)))
    return out


def test_pieces_match_jax(monkeypatch):
    jlogp, tlogp = _gauss(COV3)
    rng = np.random.default_rng(0)
    with floatx("float64"):
        z, r = rng.standard_normal(3), rng.standard_normal(3)
        diag = np.array([0.5, 1.5, 0.8])
        dense = COV3 * 0.7
        for inv_mass in (diag, dense):
            im = jnp.asarray(inv_mass)
            want = jnuts._leapfrog(jax.grad(jlogp), jnp.asarray(z), jnp.asarray(r), -0.3, im)
            zt = torch.as_tensor(z[None])
            lp, g = tsam.value_and_grad(tlogp, zt)
            got = tnuts._leapfrog(tlogp, zt, torch.as_tensor(r[None]), g,
                                  torch.tensor([-0.3], dtype=torch.float64),
                                  torch.as_tensor(inv_mass[None]))
            np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]), **TIGHT)
            np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1]), **TIGHT)
            np.testing.assert_allclose(got[2][0].item(), float(jlogp(want[0])), **TIGHT)
            # the U-turn test on both signs of the velocity products
            for first in (r, -r):
                assert bool(tnuts._uturn(torch.as_tensor(z[None]), torch.as_tensor(first[None]),
                                         torch.as_tensor(r[None]),
                                         torch.as_tensor(inv_mass[None]))[0]) == \
                    bool(jnuts._uturn(jnp.asarray(z), jnp.asarray(first), jnp.asarray(r), im))
            # the momentum from the JAX package's normals
            key = random.PRNGKey(7)
            want = jnuts._draw_momentum(key, im, jnp.float64)
            monkeypatch.setattr(tnuts, "_momentum_draws",
                                lambda gen, shape, dtype, device: torch.as_tensor(
                                    np.array(random.normal(key, shape[1:],
                                                             dtype=jnp.float64))[None]))
            got = tnuts._draw_momentum(None, torch.as_tensor(inv_mass[None]), torch.float64)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TIGHT)
        # the mass from a Welford (co)variance, and the dense fallback to its
        # diagonal when the shrunk estimate is not positive definite
        var_ok = COV3 * 1.3
        var_bad = np.array([[1.0, 3.0, 0.0], [3.0, 1.0, 0.0], [0.0, 0.0, 2.0]])
        for var, dense_flag in ((np.diag(COV3), False), (var_ok, True), (var_bad, True)):
            want = jnuts._mass_from_var(jnp.asarray(var), 12, dense_flag, jnp.float64)
            got = tnuts._mass_from_var(torch.as_tensor(var[None]), 12, dense_flag,
                                       torch.float64)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TIGHT)
        assert np.count_nonzero(got[0].numpy() - np.diag(np.diag(got[0].numpy()))) == 0


@pytest.mark.parametrize("dense", [False, True])
def test_dual_averaging_update_matches_jax(monkeypatch, dense):
    """Two dual-averaging iterations (a NUTS step each, then the step-size
    and Welford updates) from the same carry."""
    jlogp, tlogp = _gauss(COV3)
    with floatx("float64"):
        z0 = np.array([0.3, -0.2, 0.5])
        keys = random.split(random.PRNGKey(3), 2)
        carry = jnuts._dual_avg_carry0(jnp.asarray(z0), 0.25, dense)
        mu = jnp.log(10.0 * 0.25)
        want = jnuts._dual_avg_scan(jlogp, jax.grad(jlogp), carry, keys, jnp.arange(2), 5,
                                    jnp.ones(3), 0.8, mu, dense)
        NutsFeed([list(keys)]).install(monkeypatch)
        z = torch.as_tensor(z0[None])
        state = (z,) + tsam.value_and_grad(tlogp, z)
        eps0 = torch.tensor([0.25], dtype=torch.float64)
        da = tnuts._DualAveraging(z, eps0, torch.log(10.0 * eps0), 0.8, dense)
        for m in range(2):
            state, accept, _, _ = tnuts._nuts_step(tlogp, None, *state, torch.exp(da.log_eps),
                                                   5, torch.ones_like(z))
            da.update(float(m), accept, state[0])
    got = (state[0][0], da.log_eps[0], da.log_eps_bar[0], da.h_bar[0], da.w_mean[0],
           da.w_m2[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TIGHT)


def _gp_pair(n=16):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    return process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                           name="NUTS_GP"), x, y)


@pytest.mark.parametrize("target", ["gauss", "gp"])
def test_nuts_step_matches_jax(monkeypatch, target):
    with floatx("float64"):
        if target == "gauss":
            jlogp, tlogp = _gauss(COV3)
            z0 = np.array([0.4, -1.0, 0.2])
            eps, inv_mass = 0.4, np.array([1.0, 2.0, 0.5])
        else:
            jp, tp = _gp_pair()
            jlogp, tlogp = jp._sampling_logps()[0], tp._sampling_logps()[0]
            z0 = tp.active.dict_to_array(tp.params_default) + 0.1
            eps, inv_mass = 0.2, np.ones(len(z0))
        key = random.PRNGKey(11)
        want = jax.jit(lambda k, z: jnuts._nuts_step(jlogp, jax.grad(jlogp), k, z, eps, 6,
                                                     jnp.asarray(inv_mass)))(key, z0)
        lp_want = float(jlogp(want[0]))
        NutsFeed([[key]]).install(monkeypatch)
        z = torch.as_tensor(z0[None])
        lp, g = tsam.value_and_grad(tlogp, z)
        (zn, lpn, gn), accept, depth, div = tnuts._nuts_step(
            tlogp, None, z, lp, g, torch.tensor([eps], dtype=torch.float64), 6,
            torch.as_tensor(inv_mass[None]))
    np.testing.assert_allclose(zn[0].numpy(), np.asarray(want[0]), **CHAIN)
    np.testing.assert_allclose(accept[0].item(), float(want[1]), **CHAIN)
    assert int(depth[0]) == int(want[2]) >= 2 and bool(div[0]) == bool(want[3])
    np.testing.assert_allclose(lpn[0].item(), lp_want, **CHAIN)
    assert not np.allclose(zn[0].numpy(), z0)


@pytest.mark.parametrize("adapt_mass", [True, "dense"])
def test_nuts_sampler_matches_jax(monkeypatch, adapt_mass):
    jlogp, tlogp = _gauss(COV3)
    chains, warmup, samples, seed, depth = 2, 10, 5, 4, 5
    with floatx("float64"):
        z0 = np.array([[0.5, 0.1, -0.3], [-0.4, 0.8, 0.1]])
        want = jnuts.nuts_sampler(jlogp, z0, samples, warmup=warmup, key=seed,
                                  max_depth=depth, chains=chains, adapt_mass=adapt_mass,
                                  chunk=None)
        NutsFeed(_sampler_keys(seed, chains, warmup, samples, adapt_mass)).install(monkeypatch)
        calls0, leaves0 = tsam.value_and_grad.calls, tnuts.nuts_sampler.leaves
        got = tnuts.nuts_sampler(tlogp, z0, samples, warmup=warmup, key=seed, max_depth=depth,
                                 chains=chains, adapt_mass=adapt_mass, chunk=25)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **CHAIN)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **CHAIN)
    for key in ("accept_rate", "step_size"):
        np.testing.assert_allclose(got[2][key], np.asarray(want[2][key]), **CHAIN)
    # each chain's tree depths are equal; their float32 mean rounds by its sum
    np.testing.assert_allclose(got[2]["mean_tree_depth"], want[2]["mean_tree_depth"],
                               rtol=1e-6)
    np.testing.assert_array_equal(got[2]["divergences"], np.asarray(want[2]["divergences"]))
    assert set(got[2]) == set(want[2])
    # one batched evaluation for the starts and one a leaf, all chains together
    assert tsam.value_and_grad.calls - calls0 == 1 + tnuts.nuts_sampler.leaves - leaves0
    assert (np.diff(got[0], axis=1) != 0).any()
