"""The port's checkpoints against the JAX package's: a ``.npz`` written by
either package loads in the other with the same arrays, names and dtypes;
the port's directory form (the same archive inside the directory, where the
JAX package writes orbax) round-trips; tensors are saved from the host and
a Datatrace as its columns; nested dicts round-trip."""

import os

import numpy as np
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t

import torch_parity  # noqa: F401  (puts the port on the CPU)


def _tree():
    rng = np.random.default_rng(0)
    return {"GP_SE_var": np.asarray(1.3, np.float32),
            "GP_SE_rate": rng.standard_normal(3).astype(np.float32),
            "chain": rng.standard_normal((4, 5, 3)),
            "steps": np.arange(7)}


def test_npz_loads_across_packages(tmp_path):
    tree = _tree()
    jpath, tpath = str(tmp_path / "j" / "c.npz"), str(tmp_path / "t" / "c.npz")
    assert g3.save_checkpoint(tree, jpath) == jpath
    assert g3t.save_checkpoint(tree, tpath) == tpath
    for path in (jpath, tpath):
        for load in (g3.load_checkpoint, g3t.load_checkpoint):
            got = load(path)
            assert list(got) == list(tree)
            for k, v in tree.items():
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v)
    # the same archive members, byte for byte (the zip headers carry times)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert a.files == b.files
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


def test_tensors_directories_datatraces_and_nesting(tmp_path):
    tree = _tree()
    tensors = {k: torch.as_tensor(v) for k, v in tree.items()}
    path = g3t.save_checkpoint(tensors, str(tmp_path / "dir"))
    assert os.path.isfile(os.path.join(path, "checkpoint.npz"))
    got = g3t.load_checkpoint(str(tmp_path / "dir"))
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k], v)
    # saving again replaces the directory
    g3t.save_checkpoint({"a": np.ones(2)}, str(tmp_path / "dir"))
    assert list(g3t.load_checkpoint(str(tmp_path / "dir"))) == ["a"]
    dt = g3t.Datatrace({"x": np.arange(5.0), "_nchain": np.zeros(5, int)})
    back = g3t.load_checkpoint(g3t.save_checkpoint(dt, str(tmp_path / "dt.npz")))
    assert list(back) == dt.columns and np.array_equal(back["x"], dt["x"])
    nested = {"params": {"a": np.ones(2)}, "chain": np.zeros((2, 2))}
    back = g3t.load_checkpoint(g3t.save_checkpoint(nested, str(tmp_path / "n.npz")))
    assert back.params.a.tolist() == [1.0, 1.0] and back.chain.shape == (2, 2)
