"""Port parity of ``fix_vars`` and the Rao-Blackwellized ``fixed_*`` logps
(the logp averaged over the rows of a pinned chain, as tests/test_gp.py's
``fix_vars`` case): the registry's fixed view, the four ``fixed_*``
against the JAX package's (one batched K1 and one batched K2 call an
evaluation, the gradient through the batched analytic backward),
``find_MAP`` under ``fix_vars`` and its refusal of ``objective='loo'``,
``sample_hypers`` over the sampling dims fed the JAX package's draws; and
the registry's other new views (``logp_prior_array``, ``params_random``,
``params_datatrace``, ``params_serie``, the transformed names and
``transform_params``)."""

import numpy as np
import pandas as pd
import pytest
from jax import random

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.bayesian import samplers as tsam

from test_torch_samplers import _Feed, _jax_half_draws
from torch_parity import KernelSpy, assert_close, floatx, nudged, process_pair


def _pair(name, n=20, kind="GP"):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    if kind == "WGP":
        y = np.exp(0.3 * y) + 1.0
    return process_pair(lambda lib: getattr(lib, kind)(
        space=x, location=lib.Bias(), kernel=lib.SE(x),
        mapping=lib.BoxCoxLinear(y) if kind == "WGP" else None, name=name), x, y)


def _traces(tp, rows=5, seed=4):
    """The same chain of ``rows`` rows as the JAX package's DataFrame and
    the port's Datatrace."""
    u0 = tp.active.dict_to_array(nudged(tp.params_default))
    chain = u0 + 0.05 * np.random.default_rng(seed).standard_normal((rows, len(u0)))
    cols = {c: chain[:, i] for i, c in enumerate(tp.active.param_names())}
    return pd.DataFrame(cols), g3t.Datatrace(cols), u0


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_fixed_logps_match_jax(name, monkeypatch):
    with floatx(name):
        jp, tp = _pair("FXL")
        jdt, tdt, u0 = _traces(tp)
        keys = [c for c in tp.active.param_names() if "_rate" in c]
        jp.active.fix_vars(jdt, keys)
        tp.active.fix_vars(tdt, keys)
        assert tp.active.fixed_dims == jp.active.fixed_dims == [2, 3]
        assert tp.active.sampling_dims == jp.active.sampling_dims
        np.testing.assert_array_equal(tp.active.fixed_chain, jp.active.fixed_chain)
        sp = tp.active.sampling_params(u0)
        np.testing.assert_array_equal(sp, jp.active.sampling_params(u0))
        assert_close(dict(tp.active.dict_from_sampling_array(sp)),
                     dict(jp.active.dict_from_sampling_array(sp)), name)
        spy = KernelSpy(monkeypatch)
        for fn in ("fixed_logp", "fixed_dlogp", "fixed_loglike", "fixed_logprior"):
            for rows in (False, True):
                got = getattr(tp, fn)(sp, return_array=rows)
                want = getattr(jp, fn)(sp, return_array=rows)
                assert np.shape(got) == np.shape(want), fn
                assert_close(got, want, name, err_msg=fn)
            k1, k2 = spy.take()
            # one batched gram and one batched factorization an evaluation
            # (none for the prior alone)
            assert (k1, k2) == ((0, 0) if fn == "fixed_logprior" else (2, 2)), (fn, k1, k2)
        tp.active.fix_vars()
        assert tp.active.fixed_datatrace is None and tp.active.sampling_dims == [0, 1, 2, 3, 4]


def test_find_map_under_fix_vars_matches_jax():
    with floatx("float64"):
        jp, tp = _pair("FXM")
        jdt, tdt, u0 = _traces(tp, rows=4)
        keys = ["FXM_SE_rate__0"]
        jp.active.fix_vars(jdt, keys)
        tp.active.fix_vars(tdt, keys)
        start = nudged(jp.params_default)
        want = jp.find_MAP(start=start, points=1, display=False)
        got = tp.find_MAP(start=g3t.params_from_jax(tp, start), points=1, display=False)
        sw, sg = jp.active.sampling_params(want), tp.active.sampling_params(got)
        assert abs(tp.fixed_logp(sg) - float(jp.fixed_logp(sw))) < 1e-6
        np.testing.assert_allclose(sg, sw, rtol=1e-4, atol=1e-4)
        for proc in (jp, tp):
            with pytest.raises(ValueError, match="fix_vars"):
                proc.find_MAP(start=start, points=1, display=False, objective="loo")


def test_sample_hypers_with_fixed_dims_matches_jax(monkeypatch):
    """8 walkers x 6 iterations over the sampling dims against the logp
    averaged over the fixed chain, fed the JAX package's draws; the fixed
    dims of the result hold the fixed chain's mean."""
    chains, samples, seed = 8, 6, 2
    feed = _Feed()
    monkeypatch.setattr(tsam, "_half_draws", feed.half)
    with floatx("float64"):
        jp, tp = _pair("FXS", n=16)
        jdt, tdt, u0 = _traces(tp, rows=3)
        keys = ["FXS_SE_rate__0", "FXS_SE_rate__1"]
        jp.active.fix_vars(jdt, keys)
        tp.active.fix_vars(tdt, keys)
        want_chain, want_lnprob = jp.sample_hypers(start=u0, samples=samples, chains=chains,
                                                   seed=seed, raw=True)
        for k in random.split(random.PRNGKey(seed), samples):
            k1, k2 = random.split(k)
            feed.halves += [_jax_half_draws(k1, 4, 4), _jax_half_draws(k2, 4, 4)]
        chain, lnprob = tp.sample_hypers(start=u0, samples=samples, chains=chains, seed=seed,
                                         raw=True)
    assert not feed.halves
    np.testing.assert_allclose(chain, np.asarray(want_chain), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lnprob, np.asarray(want_lnprob), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(chain[..., [2, 3]],
                               np.broadcast_to(tp.active.fixed_chain[:, [2, 3]].mean(0),
                                               chain[..., [2, 3]].shape), rtol=0, atol=0)
    assert (np.diff(chain[..., [0, 1, 4]], axis=1) != 0).any()


def test_registry_views_match_jax():
    with floatx("float32"):
        jp, tp = _pair("FXV", kind="WGP")
        jr, tr = jp.active, tp.active
        jdt, tdt, u0 = _traces(tp, rows=4)
        assert tr.original_to_transformed_names == jr.original_to_transformed_names
        assert tr.transformed_to_original_names == jr.transformed_to_original_names
        params = nudged(jp.params_default)
        for kw in ({}, {"complete": True}, {"to_dict": False}):
            want = jr.transform_params(params, **kw)
            got = tr.transform_params(params, **kw)
            assert_close(dict(got) if isinstance(got, dict) else got,
                         dict(want) if isinstance(want, dict) else want, "float32")
        back = {"to_transformed": False}
        assert_close(dict(tr.transform_params(jr.transform_params(params), **back)),
                     dict(jr.transform_params(jr.transform_params(params), **back)), "float32")
        import torch
        got = tr.logp_prior_array(torch.as_tensor(u0.astype(np.float32)))
        assert_close(got, jr.logp_prior_array(u0.astype(np.float32)), "float32")
        rows = torch.as_tensor(np.stack([u0, u0 + 0.1]).astype(np.float32))
        assert_close(tr.logp_prior_array(rows)[1], jr.logp_prior_array(
            (u0 + 0.1).astype(np.float32)), "float32")
        assert_close(dict(tr.params_random(params, rng=np.random.default_rng(0))),
                     dict(jr.params_random(params, rng=np.random.default_rng(0))), "float32")
        for kw in ({}, {"iloc": 2}, {"loc": 1}):
            assert_close(dict(tr.params_datatrace(tdt, **kw)),
                         dict(jr.params_datatrace(jdt, **kw)), "float32")
        _, row = next(tdt.iterrows())
        assert_close(dict(tr.params_serie(row)), dict(jr.params_serie(jdt.iloc[0])), "float32")
