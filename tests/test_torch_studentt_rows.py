"""Port parity of the Student-t family's batched rows and fit with the JAX
package: ``logp_chain`` (one batched gram and factorization for all rows),
``batch_predict``, the averaged predictor, the ensemble chain fed the JAX
package's draws (as tests/test_torch_samplers.py does for the toy
density), and ``find_MAP``.

Tolerances: float64 against JAX x64 at rtol/atol 1e-10 (``torch_parity``);
``find_MAP``'s optimum (float64) at 1e-6 relative in logp (two BFGS runs on
different arithmetic stop a little apart)."""

import numpy as np
from jax import random

from g3py_tpu.bayesian import samplers as jsam
from g3py_tpu_torch.bayesian import samplers as tsam

from test_torch_studentt import _data, _pair
from torch_parity import assert_close, floatx


def _count_calls(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_rows_batch_predict_and_averaged_predictor(monkeypatch):
    """logp_chain, batch_predict and the averaged predictor of R rows: one
    batched gram and one batched factorization for all rows of a logp,
    against the JAX package's vmap."""
    from g3py_tpu_torch.hypers import kernels
    from g3py_tpu_torch.ops import linalg

    with floatx("float64"):
        x, y = _data()
        jp, tp = _pair("TP", "STB_TP", x, y)
        u0 = jp.active.dict_to_array(jp.params_default)
        rows = u0[None] + 0.1 * np.random.default_rng(2).standard_normal((5, len(u0)))
        grams = _count_calls(monkeypatch, kernels, "stationary_gram")
        factors = _count_calls(monkeypatch, linalg, "panel_cholesky")
        got = tp.logp_chain(rows)
        assert (len(grams), len(factors)) == (1, 1)
        assert_close(got, np.asarray(jp.logp_chain(rows)), "float64")
        flags = dict(quantiles=True, cov=True)
        want = {k: np.asarray(v) for k, v in jp.batch_predict(rows, **flags).items()}
        assert_close(tp.batch_predict(rows, **flags), want, "float64")
        ap = tp.averaged_predictor(rows)
        assert_close(ap.batch(**flags), want, "float64")
        avg = ap(**flags)
        assert_close(avg["mean"], want["mean"].mean(axis=0), "float64")


def test_ensemble_chain_matches_jax(monkeypatch):
    """The TP's ensemble chain from the JAX package's draws (rebuilt from its
    key splits, as tests/test_torch_samplers.py does for the toy density)."""
    from test_torch_samplers import _Feed, _jax_half_draws

    feed = _Feed()
    monkeypatch.setattr(tsam, "_half_draws", feed.half)
    chains, samples, seed = 8, 4, 3
    with floatx("float64"):
        x, y = _data(n=20)
        jp, tp = _pair("TP", "STC_TP", x, y)
        u0 = jp.active.dict_to_array(jp.params_default)
        p0 = u0[None] + 0.05 * np.random.default_rng(1).standard_normal((chains, len(u0)))
        jlogp, _, _ = jp._sampling_logps(prior=False)
        want_chain, want_lnprob = jsam.ensemble_sampler(jlogp, p0, samples, key=seed)
        for k in random.split(random.PRNGKey(seed), samples):
            k1, k2 = random.split(k)
            feed.halves += [_jax_half_draws(k1, 4, 4), _jax_half_draws(k2, 4, 4)]
        chain, lnprob = tsam.ensemble_sampler(tp._sampling_logps()[0], p0, samples, key=seed)
    assert not feed.halves
    np.testing.assert_allclose(chain, want_chain, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lnprob, want_lnprob, rtol=1e-10, atol=1e-10)


def test_find_map_reaches_jax_optimum():
    """float64: in float32 the two BFGS runs stop apart on rounding (the
    degree runs off towards the gaussian limit, where the logp is flat)."""
    with floatx("float64"):
        x, y = _data(n=24)
        jp, tp = _pair("TP", "STM_TP", x, y)
        jmap = jp.find_MAP(points=1, powell=False, display=False)
        tmap = tp.find_MAP(points=1, powell=False, display=False)
        lj, lt = float(jp.logp(jmap)), tp.logp(tmap)
        assert lt > tp.logp(tp.params_default) + 1.0
        np.testing.assert_allclose(lt, lj, rtol=1e-6)
        np.testing.assert_allclose(tp.logp(jmap), lj, rtol=1e-10)
