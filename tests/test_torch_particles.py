"""Port parity of the draws over datatrace rows and the row loop of the
model average: ``batch_sample`` (one draw a row, chunked), ``particles``,
``eval_params``, ``average`` with an option the batched form does not
take (``samples``, ``simulations``: the JAX package falls back to its row
loop ``_average_loop``, the port raised before), and
``clustered_predictors`` over a hand-set ``_cluster`` column, each against
the JAX package's from the same numpy generators and rows."""

import numpy as np
import pandas as pd
import pytest

import g3py_tpu_torch as g3t

from torch_parity import KernelSpy, assert_close, floatx, nudged, process_pair


def _setup(name, kind="GP", rows=4, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((18, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(18)
    xs = rng.standard_normal((6, 2))
    hidden = np.sin(xs[:, 0])
    jp, tp = process_pair(lambda lib: getattr(lib, kind)(
        space=xs, hidden=hidden, location=lib.Bias(), kernel=lib.SE(x), name=name), x, y)
    u0 = tp.active.dict_to_array(nudged(tp.params_default))
    chain = u0 + 0.05 * rng.standard_normal((rows, len(u0)))
    cols = {c: chain[:, i] for i, c in enumerate(tp.active.param_names())}
    return jp, tp, chain, pd.DataFrame(cols), g3t.Datatrace(cols)


@pytest.mark.parametrize("name", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["GP", "TP"])
def test_batch_sample_and_particles_match_jax(kind, name, monkeypatch):
    with floatx(name):
        jp, tp, chain, jdt, tdt = _setup("PB" + kind, kind)
        rows = chain.astype(name)
        want = jp.batch_sample(rows, rng=np.random.default_rng(3))
        spy = KernelSpy(monkeypatch)
        got = tp.batch_sample(rows, rng=np.random.default_rng(3))
        # the rows' states: the observed gram and one factorization; the
        # location's cross gram; the covariance's cross and query grams and
        # the (R, m, m) factorization
        assert spy.take() == (4, 2)
        assert got.shape == (len(rows), 6)
        assert_close(got, want, name)
        # one row a chunk, as the JAX package chunks
        assert_close(tp.batch_sample(rows, rng=np.random.default_rng(3), chunk=1),
                     jp.batch_sample(rows, rng=np.random.default_rng(3), chunk=1), name)
        assert spy.take() == (16, 8)
        want_p = jp.particles(jdt, nsamples=6, rng=np.random.default_rng(4))
        got_p = tp.particles(tdt, nsamples=6, rng=np.random.default_rng(4))
        assert got_p.shape == (6, 6)
        assert_close(got_p, want_p, name)
        for proc in (jp, tp):
            with pytest.raises(NotImplementedError):
                proc.batch_sample(rows, samples=3)


def test_average_falls_back_to_the_row_loop():
    """``average(dt, simulations=5)`` and ``average(dt, samples=2)`` give the
    JAX package's row-loop values (the port raised NotImplementedError from
    ``batch_predict`` before: ROADMAP Queue 3, closed)."""
    with floatx("float64"):
        jp, tp, _, jdt, tdt = _setup("PAV")
        want = jp.average(jdt, simulations=5)
        got = tp.average(tdt, simulations=5)
        assert sorted(got) == sorted(want) == ["_l1", "_l2", "mean", "std"]
        assert_close(dict(got), dict(want), "float64")
        want = jp.average(jdt, samples=2, quantiles=True)
        got = tp.average(tdt, samples=2, quantiles=True)
        assert sorted(got) == sorted(want)
        assert got["samples"].shape == np.shape(want["samples"]) == (6, 2)
        assert_close({k: got[k] for k in got if k != "samples"},
                     {k: want[k] for k in want if k != "samples"}, "float64")
        # the batched path is unchanged
        assert_close(dict(tp.average(tdt)), dict(jp.average(jdt)), "float64")


def test_eval_params_matches_jax():
    with floatx("float64"):
        jp, tp, chain, _, _ = _setup("PEV")
        params = nudged(jp.params_default)
        want = jp.eval_params(params)
        got = tp.eval_params(g3t.params_from_jax(tp, params))
        assert sorted(got) == sorted(want)
        assert_close({k: np.asarray(got[k]) for k in got}, dict(want), "float64")


def test_clustered_predictors_match_jax():
    with floatx("float64"):
        jp, tp, _, jdt, tdt = _setup("PCL", rows=5)
        labels = np.array([1, 0, 1, 0, 1])
        for dt in (jdt, tdt):
            with pytest.raises(ValueError, match="_cluster"):
                (jp if dt is jdt else tp).clustered_predictors(dt)
            dt["_cluster"] = labels
        want = jp.clustered_predictors(jdt)
        got = tp.clustered_predictors(tdt)
        assert list(got) == list(want) == [0, 1]
        xq = np.linspace(-1, 1, 8).reshape(-1, 2)
        for c in got:
            assert len(got[c].rows) == int((labels == c).sum())
            assert_close(dict(got[c](xq, quantiles=True)), dict(want[c](xq, quantiles=True)),
                         "float64")
        assert isinstance(got[0], g3t.AveragedPredictor)
