"""Process persistence on the port: ``file=`` loads the process saved there
or saves a new one; ``save`` (with ``params``) then load gives a process
whose logp is bit-equal to the saved one's; the pickled state leaves the
device copies and closures out, and tensors are stored as host values
rebuilt on the loading program's device (a file saved on the card loads
on the CPU, and the reverse); the JAX package's contract (``save`` prints
its errors) holds."""

import os
import pickle

import numpy as np
import torch

import g3py_tpu_torch as g3t
from g3py_tpu_torch.utils import _tensor_on_device, load_pkl, save_pkl

from torch_parity import floatx


def _gp(name="PERS", file=None):
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(0, 5, 20)).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(20)
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name=name, file=file)
    gp.observed(x, y)
    return gp


def test_file_is_load_or_create(tmp_path, capsys):
    path = str(tmp_path / "model.g3")
    with floatx("float64"):
        gp = _gp(file=path)
        assert os.path.isfile(path) and "Model saved" in capsys.readouterr().out
        params = {k: np.asarray(v) * 1.2 for k, v in gp.params_default.items()}
        gp.predictor(params)  # device copies of the data, dropped on save
        gp.save(params=params)
        loaded = _gp(file=path)
        assert "Loaded model" in capsys.readouterr().out
        assert loaded.logp(params) == gp.logp(params)
        assert loaded.dlogp(params).tolist() == gp.dlogp(params).tolist()
        np.testing.assert_array_equal(loaded.params[next(iter(params))],
                                      params[next(iter(params))])
        # a fresh load of the file alone, through pickle
        alone = load_pkl(path)
        assert alone._device_copies == {} and alone.logp(params) == gp.logp(params)
        gp.save(path=str(tmp_path / "no-such-dir" / "x" / "m.g3"))
        assert os.path.isfile(tmp_path / "no-such-dir" / "x" / "m.g3")
    gp.save(path=str(tmp_path))  # a directory: the error is printed, not raised
    assert "Error saving model" in capsys.readouterr().out


def test_tensors_rebuild_on_the_loading_device(tmp_path, monkeypatch):
    path = str(tmp_path / "t.pkl")
    obj = {"w": torch.arange(6.0).reshape(2, 3), "n": [torch.tensor(2, dtype=torch.int64)],
           "a": np.ones(2)}
    save_pkl(obj, path)
    with open(path, "rb") as f:
        raw = f.read()
    assert b"_tensor_on_device" in raw and b"torch._utils" not in raw
    back = load_pkl(path)
    assert back["w"].device.type == g3t.settings.device and back["w"].dtype == torch.float32
    assert back["n"][0].dtype == torch.int64 and back["n"][0].item() == 2
    torch.testing.assert_close(back["w"], obj["w"])
    # the device is the loading program's: a "meta" device stands in for the card
    monkeypatch.setattr(g3t.settings, "device", "meta")
    assert pickle.loads(raw)["w"].device.type == "meta"
    assert _tensor_on_device(np.zeros(2), "float64").device.type == "meta"
