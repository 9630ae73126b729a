"""``sample_hypers(method='nuts' | 'neutra' | 'advi')`` and
``find_MAP(engine='jax')`` through the model, with ``fix_vars`` and
``reparam='noncentered'``: the non-centered density's value and gradient
against the JAX package's (1e-10 in float64) and NUTS with a dense mass
over it (every lnprob the model's logp at its row), ADVI under ``fix_vars``
fed the JAX package's normals (1e-8), ``find_MAP(engine='jax')`` under
``fix_vars`` (the optimum to 1e-6), NUTS under ``fix_vars``; then
tests/test_samplers.py's model-level cases on the port, with shallower
trees (``max_depth=4``) than the JAX tests' default 8.  The kernels'
batched launches are counted against the evaluations (K2 adds its jitter
retries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import torch
from jax import random

import g3py_tpu_torch as g3t
import g3py_tpu_torch.ops.linalg as tlinalg
from g3py_tpu_torch.bayesian import advi as tadvi
from g3py_tpu_torch.bayesian import nuts as tnuts
from g3py_tpu_torch.bayesian import samplers as tsam

from torch_parity import KernelSpy, floatx, nudged, process_pair


def _wgp_pair(name, n=16, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2))
    y = np.exp(0.3 * (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n))) + 1.0
    return process_pair(lambda lib: lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                            mapping=lib.BoxCoxLinear(y), name=name), x, y)


def _gp_pair(name, n=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    return process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                           name=name), x, y)


def _fix_rates(jp, tp, u0, rows=3, seed=4):
    """Pin the SE rates of both packages to the same ``rows``-row chain."""
    chain = u0 + 0.05 * np.random.default_rng(seed).standard_normal((rows, len(u0)))
    cols = {c: chain[:, i] for i, c in enumerate(tp.active.param_names())}
    keys = [c for c in cols if "_rate" in c]
    jp.active.fix_vars(pd.DataFrame(cols), keys)
    tp.active.fix_vars(g3t.Datatrace(cols), keys)


def test_noncentered_gradient_matches_jax(monkeypatch):
    """The gradient of the sheared density: autograd through the shear,
    whose shift depends on the mapping's dims (jax.grad of logp(shear(v)) in
    the JAX package), one batched K1 and K2 call for the rows."""
    with floatx("float64"):
        jp, tp = _wgp_pair("SM_NCG")
        u0 = tp.active.dict_to_array(nudged(tp.params_default))
        v = u0 + 0.1 * np.random.default_rng(2).standard_normal((3, len(u0)))
        jshear, _ = jp._noncentered_sampling_shear()
        jlogp = jp._sampling_logps()[0]
        want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(lambda w: jlogp(jshear(w)))))(
            jnp.asarray(v))
        tshear, _ = tp._noncentered_sampling_shear()
        tlogp = tp._sampling_logps()[0]
        spy = KernelSpy(monkeypatch)
        got_v, got_g = tsam.value_and_grad(lambda w: tlogp(tshear(w)), torch.as_tensor(v))
        assert spy.take() == (1, 1)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-10, atol=1e-10)
    # the shift's term: without it the mapping dims' gradient differs
    plain = tsam.value_and_grad(tlogp, tshear(torch.as_tensor(v)))[1].numpy()
    assert not np.allclose(plain, got_g.numpy(), rtol=1e-6)


def test_nuts_noncentered_dense(monkeypatch):
    """NUTS with a dense mass on the non-centered WGP through the model, in
    float64: a leaf is one batched K1 and K2 call of both chains, and every
    lnprob is the model's logp at its row (the chain in the model's
    parameterization)."""
    with floatx("float64"):
        _, tp = _wgp_pair("SM_NUTS")
        u0 = tp.active.dict_to_array(nudged(tp.params_default))
        spy = KernelSpy(monkeypatch)
        retries0 = tlinalg.safe_cholesky_panels.retries
        calls0, leaves0 = tsam.value_and_grad.calls, tnuts.nuts_sampler.leaves
        chain, lnprob = tp.sample_hypers(start=u0, samples=8, chains=2, method="nuts",
                                         nuts_warmup=12, max_depth=4, nuts_mass="dense",
                                         target_accept=0.9, reparam="noncentered", seed=3,
                                         raw=True)
        leaves = tnuts.nuts_sampler.leaves - leaves0
        assert tsam.value_and_grad.calls - calls0 == 1 + leaves
        k1, k2 = spy.take()
        assert k1 == 1 + leaves == k2 - (tlinalg.safe_cholesky_panels.retries - retries0)
        np.testing.assert_allclose(lnprob.ravel(), tp.logp_chain(chain.reshape(-1, len(u0))),
                                   rtol=1e-10, atol=1e-10)
        assert (np.diff(chain, axis=1) != 0).any()


def test_advi_fixed_vars_matches_jax(monkeypatch):
    steps, mc, seed, chains, samples = 30, 3, 2, 2, 5
    with floatx("float64"):
        jp, tp = _gp_pair("SM_ADVI")
        u0 = tp.active.dict_to_array(nudged(tp.params_default))
        _fix_rates(jp, tp, u0)
        kw = dict(start=u0, samples=samples, chains=chains, method="advi", advi_steps=steps,
                  advi_mc=mc, advi_lr=0.05, seed=seed, raw=True)
        want_chain, want_lnprob = jp.sample_hypers(**kw)
        nd = len(tp.active.sampling_dims)
        eps = [np.array(random.normal(k, (mc, nd), dtype=jnp.float64))
               for k in random.split(random.PRNGKey(seed), steps)]
        monkeypatch.setattr(tadvi, "_elbo_draws",
                            lambda gen, shape, dtype, device: torch.as_tensor(eps.pop(0)))
        draws = np.array(random.normal(random.PRNGKey(seed + 1), (chains, samples, nd),
                                         dtype=jnp.float64))
        monkeypatch.setattr(tadvi, "_draws",
                            lambda gen, shape, dtype, device: torch.as_tensor(draws))
        spy = KernelSpy(monkeypatch)
        chain, lnprob = tp.sample_hypers(**kw)
        # a step is one batched call over the mc x 3 fixed rows; then the draws' lnprob
        assert spy.take() == (steps + 1, steps + 1)
    np.testing.assert_allclose(chain, np.asarray(want_chain), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(lnprob, np.asarray(want_lnprob), rtol=1e-8, atol=1e-8)
    fixed = tp.active.fixed_dims
    np.testing.assert_allclose(chain[:, :, fixed], np.broadcast_to(
        tp.active.fixed_chain[:, fixed].mean(0), chain[:, :, fixed].shape))


def test_find_map_jax_fixed_vars_matches_jax(monkeypatch):
    with floatx("float64"):
        jp, tp = _gp_pair("SM_MAP", n=20)
        u0 = tp.active.dict_to_array(nudged(tp.params_default))
        _fix_rates(jp, tp, u0)
        want = jp.find_MAP(start=tp.params_default, points=2, engine="jax", display=False)
        spy = KernelSpy(monkeypatch)
        got = tp.find_MAP(start=tp.params_default, points=2, engine="jax", display=False)
        assert spy.k1 == spy.k2 > 0
        sp = tp.active.sampling_params
        np.testing.assert_allclose(tp.fixed_logp(sp(got)), jp.fixed_logp(sp(want)), rtol=1e-6)
        np.testing.assert_allclose(sp(got), sp(want), rtol=1e-5, atol=1e-6)


# ---- tests/test_samplers.py's model-level cases on the port (float32)

def _sine_gp(name, noise=0.0, seed=0):
    x = np.linspace(0, 6, 16).astype(np.float32).reshape(-1, 1)
    y = (np.sin(x[:, 0]) + noise * np.random.default_rng(seed).standard_normal(16)
         ).astype(np.float32)
    gp = g3t.GP(space=x, location=g3t.Zero(), kernel=g3t.SE(x), name=name)
    gp.observed(x, y)
    return gp, x


def test_gp_hypers_via_nuts():
    gp, _ = _sine_gp("SM_NUTSGP")
    dt = gp.sample_hypers(start=gp.params_default, samples=40, chains=2, method="nuts",
                          nuts_warmup=40, max_depth=4, burnin_tol=None,
                          outlayer_percentile=None, seed=0)
    assert len(dt) == 80 and np.all(np.isfinite(dt["_ll"]))


def test_sample_hypers_neutra_noncentered():
    gp, _ = _sine_gp("SM_NEUTRAGP")
    dt = gp.sample_hypers(start=gp.params_default, samples=30, chains=2, method="neutra",
                          nuts_warmup=30, neutra_warmup=60, max_depth=4, burnin_tol=None,
                          outlayer_percentile=None, seed=0, reparam="noncentered")
    assert len(dt) == 60 and np.all(np.isfinite(dt["_ll"]))
    # rows in the model's parameterization: the model's logp at a row is its
    # _ll (tests/test_samplers.py's non-centered case and tolerance)
    row = np.asarray(dt[gp.active.param_names()])[7]
    np.testing.assert_allclose(gp.logp(row, array=True), dt["_ll"][7], rtol=1e-4, atol=1e-3)


def test_sample_hypers_advi():
    gp, x = _sine_gp("SM_ADVIGP", noise=0.1)
    pmap = gp.find_MAP(points=1, display=False)
    dt = gp.sample_hypers(start=pmap, samples=40, chains=2, method="advi", advi_steps=400,
                          burnin_tol=None, outlayer_percentile=None, seed=0)
    assert len(dt) == 80 and np.all(np.isfinite(dt["_ll"]))
    assert dt["_ll"].max() > float(gp.logp(pmap)) - 5.0
    avg = gp.average(dt, space=x)
    assert np.all(np.isfinite(np.asarray(avg["mean"])))


def test_nuts_fixed_vars(monkeypatch):
    _, tp = _gp_pair("SM_NUTSFIX")
    u0 = tp.active.dict_to_array(tp.params_default)
    chain = u0 + 0.05 * np.random.default_rng(4).standard_normal((3, len(u0)))
    cols = {c: chain[:, i] for i, c in enumerate(tp.active.param_names())}
    tp.active.fix_vars(g3t.Datatrace(cols), [c for c in cols if "_rate" in c])
    spy = KernelSpy(monkeypatch)
    calls0, retries0 = tsam.value_and_grad.calls, tlinalg.safe_cholesky_panels.retries
    ch, lnprob = tp.sample_hypers(start=u0, samples=10, chains=2, method="nuts",
                                  nuts_warmup=10, max_depth=4, seed=1, raw=True)
    k1, k2 = spy.take()
    calls = tsam.value_and_grad.calls - calls0
    assert k1 == calls == k2 - (tlinalg.safe_cholesky_panels.retries - retries0)
    fixed, free = tp.active.fixed_dims, tp.active.sampling_dims
    np.testing.assert_allclose(ch[:, :, fixed], np.broadcast_to(
        tp.active.fixed_chain[:, fixed].mean(0), ch[:, :, fixed].shape))
    want = np.array([tp.fixed_logp(r) for r in ch[:, :, free].reshape(-1, len(free))])
    np.testing.assert_allclose(lnprob.ravel(), want, rtol=1e-4, atol=1e-3)
    assert (np.diff(ch[:, :, free], axis=1) != 0).any()
