"""Port parity of ``sample_hypers(reparam='noncentered')``: the shear of
the amplitude hypers by the data scale and its inverse against the JAX
package's ``_noncentered_sampling_shear`` (also under ``fix_vars``), the
ensemble run with the shear fed the JAX package's draws, every datatrace
``_ll`` reproduced by the model logp at its row (as
tests/test_samplers.py's non-centered case), the tempered sampler, and the
refusals."""

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from jax import random

import g3py_tpu_torch as g3t
from g3py_tpu_torch.bayesian import samplers as tsam

from test_torch_samplers import _Feed, _jax_half_draws
from torch_parity import assert_close, floatx, nudged, process_pair


def _pair(name, n=16, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2))
    y = np.exp(0.3 * (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n))) + 1.0
    return process_pair(lambda lib: lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                            mapping=lib.BoxCoxLinear(y), name=name), x, y)


@pytest.mark.parametrize("name", ["float64", "float32"])
@pytest.mark.parametrize("fixed", [False, True])
def test_shear_matches_jax(fixed, name):
    with floatx(name):
        jp, tp = _pair("NCS")
        u0 = tp.active.dict_to_array(nudged(tp.params_default))
        if fixed:  # the shear then runs over the sampling dims only
            cols = {c: np.tile(u0[i], 2) for i, c in enumerate(tp.active.param_names())}
            keys = ["NCS_SE_rate__0"]
            jp.active.fix_vars(pd.DataFrame(cols), keys)
            tp.active.fix_vars(g3t.Datatrace(cols), keys)
        dims = tp.active.sampling_dims
        v = (u0[dims] + 0.2 * np.random.default_rng(1).standard_normal((5, len(dims)))
             ).astype(name)
        js, ju = jp._noncentered_sampling_shear()
        ts, tu = tp._noncentered_sampling_shear()
        got = ts(torch.as_tensor(v))
        assert_close(got, jax.vmap(js)(v), name)
        assert_close(tu(torch.as_tensor(v)), jax.vmap(ju)(v), name)
        assert_close(tu(got), v, name)
        moved = np.flatnonzero((got.numpy() != v).any(0))
        names = [tp.active.param_names()[d] for d in np.asarray(dims)[moved]]
        assert names == ["NCS_SE_var", "NCS_Noise_var"], names


def test_sample_hypers_noncentered_matches_jax(monkeypatch):
    chains, samples, seed = 8, 8, 3
    feed = _Feed()
    monkeypatch.setattr(tsam, "_half_draws", feed.half)
    with floatx("float64"):
        jp, tp = _pair("NCH")
        u0 = tp.active.dict_to_array(nudged(tp.params_default))
        kw = dict(start=u0, samples=samples, chains=chains, seed=seed, burnin_tol=None,
                  reparam="noncentered")
        jdt = jp.sample_hypers(**kw)
        for k in random.split(random.PRNGKey(seed), samples):
            k1, k2 = random.split(k)
            feed.halves += [_jax_half_draws(k1, 4, 4), _jax_half_draws(k2, 4, 4)]
        tdt = tp.sample_hypers(**kw)
        assert not feed.halves
        cols = tp.active.param_names()
        np.testing.assert_allclose(tdt[cols], np.asarray(jdt[cols]), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(tdt["_ll"], np.asarray(jdt["_ll"]), rtol=1e-10, atol=1e-10)
        # the chain is in the model's parameterization: each _ll is the
        # model's logp at its row
        rows = np.asarray(tdt[cols])
        np.testing.assert_allclose(tdt["_ll"], tp.logp_chain(rows), rtol=1e-10, atol=1e-10)
        assert (np.diff(rows.reshape(chains, samples, -1), axis=1) != 0).any()


def test_tempered_noncentered_and_refusals():
    with floatx("float32"):
        jp, tp = _pair("NCT", n=12)
        u0 = tp.active.dict_to_array(tp.params_default)
        chain, lnprob = tp.sample_hypers(start=u0, samples=4, chains=8, ntemps=2, raw=True,
                                         reparam="noncentered")
        assert chain.shape[-1] == tp.active.ndim and np.all(np.isfinite(lnprob))
        for kw, err in (({"method": "slice"}, ValueError),
                        ({"reparam": "centered"}, ValueError)):
            with pytest.raises(err):
                tp.sample_hypers(start=u0, samples=2, chains=8, **kw)
        x = np.linspace(0, 1, 8)[:, None]
        flat = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x, var=1.0), noisy=False,
                      name="NCF")
        flat.observed(x, np.sin(x[:, 0]))
        with pytest.raises(ValueError, match="does not apply"):
            flat.sample_hypers(start=flat.active.dict_to_array(flat.params_default),
                               samples=2, chains=4, reparam="noncentered")
