"""The port's dataset loaders against the JAX package's, exactly: every
loader's arrays (values, dtypes, shapes), the frames as Datatraces (the
same columns in order, the same values and dtypes, the same row labels),
the statsmodels series' synthetic surrogates and their warning, and CSV
files written by either package read back by the other."""

import warnings

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.utils import data as jdata
from g3py_tpu_torch.utils import data as tdata


def _same(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    np.testing.assert_array_equal(got, want, err_msg=label)


def _same_frame(dt, df, label):
    assert dt.columns == list(df.columns), label
    np.testing.assert_array_equal(dt.index, df.index.to_numpy(), err_msg=label)
    for c in df.columns:
        want = df[c].to_numpy()
        if want.dtype.kind in "OUT":  # pandas' string columns
            assert [str(v) for v in dt[c]] == [str(v) for v in want], (label, c)
        else:
            _same(dt[c], want, f"{label} {c}")


@pytest.mark.parametrize("name", ["data_sunspots", "data_heart", "data_eurusd", "data_co2",
                                  "data_engel"])
def test_series_match_jax(name):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = getattr(jdata, name)()
        n_jax = len(caught)
        got = getattr(tdata, name)()
    # the statsmodels series warn that they are surrogates, in both packages
    assert len(caught) == 2 * n_jax and n_jax == (name in ("data_co2", "data_engel"))
    for i in range(2):
        _same(got[i], want[i], f"{name}[{i}]")


@pytest.mark.parametrize("name", ["data_abalone", "data_creep", "data_ailerons"])
@pytest.mark.parametrize("raw", [False, True])
def test_tables_match_jax(name, raw):
    _same_frame(getattr(tdata, name)(dataframe=True, raw=raw),
                getattr(jdata, name)(dataframe=True, raw=raw), name)
    if not raw:
        want, got = getattr(jdata, name)(), getattr(tdata, name)()
        _same(got[0], want[0], name + " x")
        _same(got[1], want[1], name + " y")


def test_rivers_and_paths_match_jax():
    _same_frame(tdata.data_rivers(), jdata.data_rivers(), "rivers")
    assert tdata.datasets_path("abalone.data") is not None
    assert tdata.datasets_path("no-such-file") is None
    assert g3t.data_abalone is tdata.data_abalone and g3t.save_csv is tdata.save_csv


def test_csv_round_trips_across_packages(tmp_path):
    import pandas as pd

    dt = g3t.Datatrace({"a": np.array([0.1, 2.5, -3.0]), "n": np.array([1, 2, 3]),
                        "b": np.array([True, False, True])})
    g3t.save_csv(dt, str(tmp_path / "t.csv"))
    _same_frame(g3t.load_csv(str(tmp_path / "t.csv")), g3.load_csv(str(tmp_path / "t.csv")),
                "port's file")
    df = pd.DataFrame({"a": [0.1, 2.5, -3.0], "n": [1, 2, 3], "b": [True, False, True]})
    g3.save_csv(df, str(tmp_path / "j.csv"))
    _same_frame(g3t.load_csv(str(tmp_path / "j.csv")), g3.load_csv(str(tmp_path / "j.csv")),
                "JAX package's file")
    assert open(tmp_path / "t.csv").read() == open(tmp_path / "j.csv").read()
