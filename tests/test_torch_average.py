"""Port parity of the datatrace and the model average: the columns and
flags of ``chains_to_datatrace``, ``gelman_rubin`` (three methods),
``burn_in_samples`` and the mESS estimators against the JAX package's on
fixed chains, ``average`` and the ``AveragedPredictor`` against the JAX
package's on a 4-row datatrace, and ``sample_hypers`` end to end.
"""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.bayesian import average as javg
from g3py_tpu_torch.bayesian import average as tavg

from torch_parity import assert_close, floatx


def _pair(kind, name, n=24, d=2):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    if kind == "gp":
        jp = g3.GP(space=x, location=g3.Bias(), kernel=g3.SE(x), name=name)
        tp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name=name)
    else:
        y = (np.exp(0.3 * y) + 1.0).astype(np.float32)
        jp = g3.WGP(space=x, location=g3.Bias(), kernel=g3.SE(x),
                    mapping=g3.BoxCoxLinear(y), name=name)
        tp = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x),
                     mapping=g3t.BoxCoxLinear(y), name=name)
    jp.observed(x, y)
    tp.observed(x, y)
    return jp, tp


def _chains(seed, nchain=4, niter=60, ndim=5, drift=True):
    """AR(1) walkers; with ``drift`` the first third starts far off, so
    burn-in and R-hat have something to find."""
    rng = np.random.default_rng(seed)
    x = np.zeros((nchain, niter, ndim))
    x[:, 0] = rng.normal(size=(nchain, ndim)) * (5.0 if drift else 1.0)
    for t in range(1, niter):
        x[:, t] = 0.8 * x[:, t - 1] + rng.normal(size=(nchain, ndim))
    return x.astype(np.float32)


def _assert_same_datatrace(tdt, jdt):
    assert tdt.columns == list(jdt.columns)
    for c in jdt.columns:
        want = np.asarray(jdt[c])
        got = tdt[c]
        if want.dtype == bool or c in ("_nchain", "_niter"):
            np.testing.assert_array_equal(got, want, err_msg=c)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=c)


@pytest.mark.parametrize("burnin_tol", [None, 0.5])
def test_chains_to_datatrace_matches_jax(burnin_tol):
    jp, tp = _pair("wgp", "DT_WGP")
    chains = _chains(0, ndim=tp.active.ndim)
    ll = np.random.default_rng(1).normal(size=chains.shape[:2]).astype(np.float32)
    ll[1, 3] = -np.inf
    chains[2, 5, 0] = 40.0  # an outlier
    kw = dict(ll=ll, burnin_tol=burnin_tol, outlayer_percentile=0.01)
    jdt = g3.chains_to_datatrace(jp, chains, **kw)
    tdt = g3t.chains_to_datatrace(tp, chains, **kw)
    _assert_same_datatrace(tdt, jdt)
    assert not tdt["_outlayer"].all()
    for flat, burnin in ((False, False), (True, False), (False, True)):
        np.testing.assert_array_equal(
            g3t.datatrace_to_chains(tp, tdt, flat=flat, burnin=burnin),
            g3.datatrace_to_chains(jp, jdt, flat=flat, burnin=burnin))


@pytest.mark.parametrize("method", ["multi-sum", "multi-max", "uni"])
def test_gelman_rubin_and_burn_in_match_jax(method):
    chains = _chains(2)
    for c in (chains, chains[:, 30:]):
        assert tavg.gelman_rubin(c, method) == pytest.approx(
            javg.gelman_rubin(c, method), rel=1e-9, abs=1e-12)
    for tol in (0.1, 0.5):
        assert tavg.burn_in_samples(chains, tol, method) == javg.burn_in_samples(
            chains, tol, method)
    assert tavg.gelman_rubin(chains[:1], method) == 0.0


@pytest.mark.parametrize("method,batch_size", [("mIS", None), ("adjusted", None),
                                               ("batch", 5), ("mIS", 1)])
def test_mess_matches_jax(method, batch_size):
    chain = _chains(3, nchain=1, niter=80, drift=False)[0].astype(np.float64)
    assert tavg._mESS(chain, method, batch_size) == pytest.approx(
        javg._mESS(chain, method, batch_size), rel=1e-9)


def test_effective_sample_size_matches_jax():
    jp, tp = _pair("gp", "ESS_GP")
    chains = _chains(4, ndim=tp.active.ndim)
    jdt = g3.chains_to_datatrace(jp, chains, burnin_tol=0.5)
    tdt = g3t.chains_to_datatrace(tp, chains, burnin_tol=0.5)
    for kw in ({}, {"reshape": True}, {"flat": True}):
        assert g3t.effective_sample_size(tp, tdt, **kw) == g3.effective_sample_size(
            jp, jdt, **kw)
    assert g3t.effective_sample_min(tp) == pytest.approx(g3.effective_sample_min(jp))


@pytest.mark.parametrize("kind,name", [("wgp", "float64")])
def test_average_and_averaged_predictor_match_jax(kind, name):
    with floatx(name):
        jp, tp = _pair(kind, f"AV_{kind.upper()}_{name[-2:]}")
        u0 = jp.active.dict_to_array(jp.params_default)
        rows = (u0 + 0.2 * np.random.default_rng(6).standard_normal((4, len(u0)))).astype(name)
        jdt = g3.chains_to_datatrace(jp, rows[None], burnin_tol=None)
        tdt = g3t.chains_to_datatrace(tp, rows[None], burnin_tol=None)
        xq = np.linspace(-2, 2, 7).reshape(-1, 1).repeat(2, axis=1).astype(name)
        kw = dict(space=xq, quantiles=True)
        want = dict(jp.average(jdt, **kw))
        assert_close(dict(tp.average(tdt, **kw)), want, name=name)
        ap = tp.averaged_predictor(tdt, max_rows=4)
        assert_close(dict(ap(xq, quantiles=True)), want, name=name)
        assert_close(dict(ap.batch(xq)), dict(jp.batch_predict(rows, space=xq)), name=name)
        # max_rows keeps evenly spaced rows, as in the JAX package
        sub = tp.averaged_predictor(tdt, max_rows=2)
        np.testing.assert_array_equal(sub.rows, rows[[0, 3]])


def test_sample_hypers_end_to_end():
    """A short WGP run: the datatrace's shape and columns, raw arrays,
    tempering, clusters, and the options that are not ported raising
    (``reparam`` and ``fix_vars`` are ported: tests/test_torch_noncentered.py
    and tests/test_torch_fixed.py)."""
    jp, tp = _pair("wgp", "SH_WGP", n=16)
    u0 = tp.active.dict_to_array(tp.params_default)
    dt = tp.sample_hypers(start=u0, samples=12, chains=8, burnin_tol=0.5)
    moved = (np.diff(g3t.datatrace_to_chains(tp, dt), axis=1) != 0).any(-1)
    assert len(dt) == 8 * 12 and 0.0 < moved.mean() < 1.0
    jdt = g3.chains_to_datatrace(jp, np.zeros((8, 12, tp.active.ndim), np.float32),
                                 ll=np.zeros((8, 12), np.float32), burnin_tol=0.5)
    assert dt.columns == list(jdt.columns)
    assert np.all(np.isfinite(dt["_ll"])) and dt["_ll"].max() > -1e29
    np.testing.assert_allclose(dt["_ll"], tp.logp_chain(g3t.datatrace_to_chains(tp, dt,
                                                                                flat=True)),
                               rtol=1e-5, atol=1e-4)
    chain, lnprob = tp.sample_hypers(start=u0, samples=4, chains=8, ntemps=3, raw=True)
    assert chain.shape == (8, 4, tp.active.ndim) and lnprob.shape == (8, 4)
    # file= and clusters= are ported (tests/test_torch_registry_io.py): a
    # parquet path is the JAX package's format, refused; plots wait
    with pytest.raises(ValueError, match=".npz"):
        tp.sample_hypers(start=u0, samples=2, chains=8, file="x.parquet", load=False)
    # plot=True draws the datatrace panels (the Agg backend here)
    dt_plot = tp.sample_hypers(start=u0, samples=2, chains=8, plot=True)
    assert len(dt_plot) == 16
    g3t.utils.plots.pyplot().close("all")
    dt = tp.sample_hypers(start=u0, samples=12, chains=8, burnin_tol=0.5, clusters=2)
    assert set(np.unique(dt["_cluster"])) <= {0, 1}
