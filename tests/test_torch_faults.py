"""The port's repairs of faults F3 and F4 (ROADMAP Queue 3).

* F3: the host-facing statistics (``predict``, the statistic methods, the
  predictors' calls) return host numpy arrays, so numpy's reductions and
  ``np.asarray`` take them as they take the JAX package's arrays — the
  tutorials' ``np.all(np.isfinite(pred["mean"]))``; the ``th_*`` functions
  and the statistics' bodies (``config.device_statistics``, what the port's
  own consumers call) keep device tensors, and every family's override of
  a public statistic is a host statistic too.
* F4: ``Datatrace`` has pandas' frame view: ``dt[cols]`` a column subset
  whose ``np.asarray`` is the matrix, ``dt[a:b]`` rows, and ``iloc`` —
  tutorial 04's ``dt[cols].iloc[::k][:10]`` and ``rows.iloc[i][c]`` held
  to the same expressions on a pandas frame of the same columns."""

import numpy as np
import pandas as pd
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.config import device_statistics
from g3py_tpu_torch.utils.datatrace import Datatrace

from torch_parity import floatx, process_pair


def _pair(name):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 6.0, 24)).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(24)
    return process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                           name=name), x, y)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_statistics_are_host_arrays_numpy_reduces(name):
    with floatx(name):
        jp, tp = _pair(f"F3_{name}")
        want = jp.predict(jp.params_default, quantiles=True, quantiles_noise=True, samples=2)
        got = tp.predict(tp.params_default, quantiles=True, quantiles_noise=True, samples=2)
        assert set(got) == set(want)
        for k, v in got.items():
            assert isinstance(v, np.ndarray) and v.dtype == np.dtype(name), k
            assert v.shape == np.asarray(want[k]).shape, k
            # the tutorials' reductions, as on the JAX package's arrays
            assert np.all(np.isfinite(v)) == bool(np.all(np.isfinite(want[k])))
            assert np.asarray(v) is v or np.array_equal(np.asarray(v), v)
        assert np.all(got["quantile_up"] >= got["quantile_down"])
        np.testing.assert_allclose(np.mean(got["mean"]), np.mean(np.asarray(want["mean"])),
                                   rtol=1e-4)
        for stat in (tp.mean(), tp.std(), tp.quantiler(q=0.9), tp.sampler(samples=3),
                     tp.predictor()(tp.space)["std"], tp.predictor().median(tp.space)):
            assert isinstance(stat, np.ndarray) and np.all(np.isfinite(stat))


def test_inner_calls_and_th_functions_keep_tensors():
    with floatx("float64"):
        _, tp = _pair("F3_TENSORS")
        mean = device_statistics(tp).mean()
        pred = device_statistics(tp.predictor()).predict(tp.space)
        assert isinstance(mean, torch.Tensor) and isinstance(pred["mean"], torch.Tensor)
        p = tp._tensor_params(tp.params_default)
        th = tp.th_mean()(p, *tp._resolve_data(None, None, None),
                          torch.zeros(len(tp.space), dtype=torch.float64))
        assert isinstance(th, torch.Tensor)
        np.testing.assert_array_equal(mean.numpy(), tp.mean())
        np.testing.assert_array_equal(th.numpy(), tp.mean())


def _subclasses(cls):
    for sub in cls.__subclasses__():
        yield sub
        yield from _subclasses(sub)


def test_every_family_override_is_a_host_statistic():
    """A family that overrides a public statistic of StochasticProcess
    (``quantiler``, ``sampler``, ``mean``, ...) decorates it as well."""
    from g3py_tpu_torch.models.stochastic import StochasticProcess

    public = [name for name in dir(StochasticProcess)
              if getattr(getattr(StochasticProcess, name), "host_statistic", False)]
    assert {"predict", "mean", "std", "quantiler", "sampler", "sample"} <= set(public)
    families = list(_subclasses(StochasticProcess))
    assert len(families) > 20
    for cls in families:
        for name in public:
            if name in cls.__dict__:
                assert getattr(cls.__dict__[name], "host_statistic", False), (cls, name)


def _frame():
    rng = np.random.default_rng(2)
    cols = {"a": rng.normal(size=30), "b": rng.normal(size=30), "_ll": rng.normal(size=30)}
    return Datatrace(cols), pd.DataFrame(cols)


def test_datatrace_frame_view_matches_pandas():
    dt, df = _frame()
    cols = ["a", "b"]
    got, want = dt[cols].iloc[::max(len(dt) // 10, 1)][:10], df[cols].iloc[::3][:10]
    assert isinstance(got, Datatrace) and got.columns == cols and len(got) == len(want)
    np.testing.assert_array_equal(np.asarray(got), want.to_numpy())
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.to_numpy(np.float32), want.to_numpy(np.float32))
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    for i in range(len(got)):
        for c in cols:
            assert got.iloc[i][c] == want.iloc[i][c]
    assert got.iloc[-1]["b"] == want.iloc[-1]["b"]
    np.testing.assert_array_equal(np.asarray(dt[2:7]), df[2:7].to_numpy())
    mask = dt["a"] > 0
    np.testing.assert_array_equal(np.asarray(dt.iloc[mask]), df.iloc[mask].to_numpy())
    np.testing.assert_array_equal(np.asarray(dt.iloc[[4, 1]]), df.iloc[[4, 1]].to_numpy())
    with pytest.raises(IndexError):
        dt.iloc[30]
    with pytest.raises(KeyError):
        dt[["a", "zz"]]


def test_tutorial04_rows_through_the_registry():
    """Tutorial 04's fix_vars rows: ``iloc`` rows of a sampler's datatrace
    as params dicts, back to the flat vectors."""
    with floatx("float64"):
        jp, tp = _pair("F4_GP")
        rows = np.random.default_rng(5).normal(size=(12, tp.active.ndim))
        dt = g3t.chains_to_datatrace(tp, rows.reshape(3, 4, -1), burnin_tol=None)
        cols = tp.active.param_names()
        fixed = dt[cols].iloc[::2][:4]
        got = np.stack([tp.active.dict_to_array({c: fixed.iloc[i][c] for c in cols})
                        for i in range(len(fixed))])
        jdt = g3.chains_to_datatrace(jp, rows.reshape(3, 4, -1), burnin_tol=None)
        jfixed = jdt[cols].iloc[::2][:4]
        want = np.stack([jp.active.dict_to_array({c: jfixed.iloc[i][c] for c in cols})
                         for i in range(len(jfixed))])
    np.testing.assert_allclose(got, want, rtol=1e-12)
