"""Port parity of the persistence helpers (``g3py_tpu_torch/utils``):
``save_pkl``/``load_pkl``, ``save_json``, ``clone``, ``random_state``,
the ``.npz`` datatrace files (column order, dtypes, the JAX package's
forgiving ``None`` on an unreadable file, a ValueError naming ``.npz`` for
the JAX package's parquet/HDF5 paths), ``random_obs``/``uniform_obs``
against the JAX package's index sets, the registry's ``save``/``load``/
``reset`` and ``GraphicalModel(file=)`` (pickled with every tensor on the
CPU), and ``sample_hypers(file=)`` writing and reloading its datatrace."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
from g3py_tpu.utils import data as jdata
from g3py_tpu_torch.bayesian.registry import _to_cpu
from g3py_tpu_torch.utils import data as tdata

import torch_parity  # noqa: F401  (puts the port on the CPU)


@pytest.mark.parametrize("p,s", [(0.2, 1.0), (0.5, 0.8), (7, 30)])
def test_random_and_uniform_obs_match_jax(p, s):
    x = np.arange(50)
    for seed in (0, 3):
        want = jdata.random_obs(x, p, s, rng=np.random.default_rng(seed))
        got = tdata.random_obs(x, p, s, rng=np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(tdata.uniform_obs(x, p, s), jdata.uniform_obs(x, p, s)):
        np.testing.assert_array_equal(g, w)


def test_persistence_helpers(tmp_path):
    path = str(tmp_path / "sub" / "obj.pkl")
    obj = {"a": np.arange(3), "b": [1, "x"]}
    g3t.save_pkl(obj, path)
    back = g3t.load_pkl(path)
    np.testing.assert_array_equal(back["a"], obj["a"])
    assert back["b"] == obj["b"]
    g3t.save_json({"k": 1.5}, str(tmp_path / "j" / "f.json"))
    assert json.load(open(tmp_path / "j" / "f.json")) == {"k": 1.5}
    d = g3t.DictObj({"a": 1})
    c = g3t.clone(d)
    assert c == d and c is not d
    np.testing.assert_array_equal(g3t.random_state(4).standard_normal(3),
                                  np.random.default_rng(4).standard_normal(3))


def test_datatrace_npz_round_trip(tmp_path, capsys):
    dt = g3t.Datatrace({"z_log_": np.linspace(0, 1, 5, dtype=np.float32),
                        "a": np.arange(5, dtype=np.float64),
                        "_nchain": np.zeros(5, dtype=np.int64),
                        "_burnin": np.array([0, 1, 1, 0, 1], dtype=bool)})
    path = str(tmp_path / "dt.npz")
    g3t.save_datatrace(dt, path)
    back = g3t.load_datatrace(path)
    assert back.columns == dt.columns
    for c in dt.columns:
        assert back[c].dtype == dt[c].dtype
        np.testing.assert_array_equal(back[c], dt[c])
    # mode 'a' keeps the file's first key; 'w' writes a new file
    g3t.save_datatrace(dt[np.arange(2)], path, key="second", mode="a")
    assert len(g3t.load_datatrace(path)) == 5
    g3t.save_datatrace(dt[np.arange(2)], path, key="second")
    assert len(g3t.load_datatrace(path)) == 2
    for bad in ("dt.parquet", "dt.h5"):
        with pytest.raises(ValueError, match=".npz"):
            g3t.save_datatrace(dt, str(tmp_path / bad))
        assert g3t.load_datatrace(str(tmp_path / bad)) is None
    assert g3t.load_datatrace(str(tmp_path / "missing.npz")) is None
    assert ".npz" in capsys.readouterr().out


def test_registry_save_load_reset(tmp_path):
    g3t.GraphicalModel.active = None
    try:
        x = np.linspace(0, 1, 12)[:, None]
        y = np.sin(3 * x[:, 0])
        gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="IO_GP")
        gp.observed(x, y)
        logp = gp.logp()
        gp.active.set_params(gp.params_default)
        path = str(tmp_path / "model.pkl")
        gp.active.save(path)
        loaded = g3t.GraphicalModel.load(path)
        assert g3t.GraphicalModel.active is loaded
        assert list(loaded.params_spec) == list(gp.active.params_spec)
        assert loaded.components["IO_GP"].logp() == logp
        fresh = g3t.GraphicalModel(name="other", file=path)
        assert list(fresh.params_spec) == list(gp.active.params_spec)
        assert g3t.GraphicalModel.active is fresh
        reg = g3t.GraphicalModel(name="new", file=str(tmp_path / "new.pkl"), reset=True)
        assert os.path.exists(tmp_path / "new.pkl") and reg.name == "new"
        reg.current_params = {"v": torch.ones(2)}
        reg.reset()
        assert reg.current_params is None
    finally:
        g3t.GraphicalModel.active = None


def test_pickled_state_is_on_the_cpu():
    """What a registry or a process pickles holds CPU tensors only (here
    checked on CPU tensors with a recorded device, the state's walk); the
    device copies of the data are left out."""
    state = {"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(1), 3)],
             "c": g3t.DictObj({"d": torch.ones(1)})}
    out = _to_cpu(state)
    assert out["a"].device.type == "cpu" and isinstance(out["c"], g3t.DictObj)
    assert isinstance(out["b"][1], tuple) and out["b"][1][1] == 3
    x = np.linspace(0, 1, 8)[:, None]
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="IO_DEV")
    gp.observed(x, np.sin(x[:, 0]))
    gp.logp()
    assert gp._device_copies
    clone = pickle.loads(pickle.dumps(gp))
    assert clone._device_copies == {}
    assert clone.logp() == gp.logp()


def test_sample_hypers_file_and_clusters(tmp_path):
    """``file=`` writes the datatrace; a second call of the same shape
    reads it back instead of sampling; ``clusters=`` labels the rows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 1))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(16)
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="IO_SH")
    gp.observed(x, y)
    u0 = gp.active.dict_to_array(gp.params_default)
    path = str(tmp_path / "trace.npz")
    np.random.seed(0)
    dt = gp.sample_hypers(start=u0, samples=30, chains=8, burnin_tol=0.5, file=path,
                          clusters=2)
    assert "_cluster" in dt and set(np.unique(dt["_cluster"])) <= {0, 1}
    back = gp.sample_hypers(start=u0, samples=30, chains=8, file=path)
    assert back.columns == dt.columns
    np.testing.assert_array_equal(back["_ll"], dt["_ll"])
    other = gp.sample_hypers(start=u0, samples=4, chains=8, file=path, load=False)
    assert len(other) == 32
