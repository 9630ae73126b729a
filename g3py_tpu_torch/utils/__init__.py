"""Containers and cross-package helpers.

* :class:`DictObj` — dict with attribute access (as in :mod:`g3py_tpu.utils`).
* :class:`MaxTime` and :func:`nan_to_high` — the optimizer's wall-clock
  budget and NaN/Inf hardening (as in :mod:`g3py_tpu.utils`).
* :func:`params_from_jax` — carry a natural-space params dict from the JAX
  package (numpy arrays keyed by hyper name) into this package's dict of
  tensors on ``settings.device``, checked against the process's registry.
  It takes plain numpy input and imports nothing of JAX.
* :func:`flow_from_jax` — carry a NeuTra flow's params from the JAX package
  into this package's :class:`~g3py_tpu_torch.bayesian.neutra.Flow`, with
  the same checks.
* persistence: :func:`save_pkl`/:func:`load_pkl`, :func:`save_json`, and
  :func:`save_datatrace`/:func:`load_datatrace` for the port's
  :class:`~g3py_tpu_torch.utils.datatrace.Datatrace` in numpy's ``.npz``
  format (the JAX package writes pandas frames as parquet or HDF5; the port
  has neither pandas nor h5py), the column order kept.
"""

import json
import os
import pickle
import time
from copy import copy

import numpy as np

__all__ = ["DictObj", "MaxTime", "clone", "nan_to_high", "save_pkl", "load_pkl",
           "save_datatrace", "load_datatrace", "save_json", "random_state",
           "params_from_jax", "flow_from_jax"]


class DictObj(dict):
    """dict with attribute access."""

    def __init__(self, data=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if data is not None:
            for k, v in data.items():
                self[k] = v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError("No such attribute: " + name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        if name in self:
            del self[name]
        else:
            raise AttributeError("No such attribute: " + name)

    def copy(self):
        return DictObj(data=self)


class MaxTime:
    """Optimizer callback raising ``TimeoutError`` once a wall-clock budget
    of ``max_sec`` seconds is spent."""

    def __init__(self, max_sec=60):
        self.max_sec = max_sec + time.time()

    def __call__(self, xk=None):
        if time.time() > self.max_sec:
            raise TimeoutError("Terminating: time limit reached")


def clone(c):
    """A shallow copy."""
    return copy(c)


def nan_to_high(x):
    """Replace non-finite entries with 1e100 so scipy optimizers never see
    NaN/Inf."""
    return np.where(np.isfinite(x), x, 1.0e100)


def _ensure_dir(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _tensor_on_device(values, dtype):
    """A pickled tensor, rebuilt on ``settings.device`` at load time."""
    import torch

    from ..config import settings
    return torch.as_tensor(values, dtype=getattr(torch, dtype), device=settings.device)


class _DevicePickler(pickle.Pickler):
    """Pickles every tensor as its host values and dtype, to be rebuilt on
    the loading program's device: a file saved from the card loads on the
    CPU, and the reverse."""

    def reducer_override(self, obj):
        import torch

        if isinstance(obj, torch.Tensor):
            return _tensor_on_device, (obj.detach().cpu().numpy(), str(obj.dtype)[6:])
        return NotImplemented


def save_pkl(to_pkl, path="file.pkl"):
    """Pickle ``to_pkl`` to ``path``; its tensors are stored as host values
    and come back on ``settings.device`` (see :class:`_DevicePickler`)."""
    _ensure_dir(path)
    with open(path, "wb") as f:
        _DevicePickler(f, protocol=-1).dump(to_pkl)


def load_pkl(path="file.pkl"):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_json(dict_to_json, path="file.json"):
    _ensure_dir(path)
    with open(path, "w") as f:
        json.dump(dict_to_json, fp=f)


def random_state(seed=None):
    """A numpy Generator, the host-side RNG."""
    return np.random.default_rng(seed)


_NPZ_ONLY = ("the port writes datatraces as numpy .npz files (no pandas/h5py); "
             "got {path!r}")


def save_datatrace(dt, path="datatrace.npz", key="datatrace", mode="w"):
    """Write a :class:`~g3py_tpu_torch.utils.datatrace.Datatrace` to an
    ``.npz`` file: one array a column, under ``<key>/<position>``, and the
    column names in order under ``<key>/columns``.  ``mode`` 'w' writes a
    new file; 'a' keeps the file's other keys.  A ``.parquet``/``.h5`` path
    raises ``ValueError`` (the JAX package's formats)."""
    if not path.endswith(".npz"):
        raise ValueError(_NPZ_ONLY.format(path=path))
    _ensure_dir(path)
    arrays = {}
    if mode == "a" and os.path.exists(path):
        with np.load(path, allow_pickle=False) as old:
            arrays = {k: old[k] for k in old.files if not k.startswith(key + "/")}
    arrays[key + "/columns"] = np.asarray(dt.columns, dtype=str)
    for i, c in enumerate(dt.columns):
        arrays[f"{key}/{i}"] = np.asarray(dt[c])
    with open(path, "wb") as f:  # np.savez would append .npz to another suffix
        np.savez(f, **arrays)


def load_datatrace(path="datatrace.npz"):
    """The Datatrace of an ``.npz`` file written by :func:`save_datatrace`
    (the file's first key), or None (the error printed) when the file
    cannot be read, as the JAX package's loader forgives."""
    from .datatrace import Datatrace

    try:
        if not path.endswith(".npz"):
            raise ValueError(_NPZ_ONLY.format(path=path))
        with np.load(path, allow_pickle=False) as f:
            key = next(k for k in f.files if k.endswith("/columns"))[:-len("/columns")]
            cols = [str(c) for c in f[key + "/columns"]]
            return Datatrace({c: f[f"{key}/{i}"] for i, c in enumerate(cols)})
    except Exception as e:
        print(e)
        return None


def params_from_jax(process, params):
    """Natural-space params of the JAX package -> this package's tensors.

    ``params`` maps every hyper name of ``process``'s registry to an array
    (numpy, or anything ``np.asarray`` takes) of that hyper's shape.  Raises
    ``KeyError`` on a missing or extra name and ``ValueError`` on a wrongly
    shaped value; returns a :class:`DictObj` of tensors in
    ``settings.floatx`` on ``settings.device``, in registry order."""
    from ..config import as_tensor

    spec = process.active.params_spec
    missing = [k for k in spec if k not in params]
    extra = [k for k in params if k not in spec]
    if missing or extra:
        raise KeyError(f"params_from_jax: missing {missing}, unexpected {extra}")
    out = DictObj()
    for name, p in spec.items():
        v = np.asarray(params[name])
        if v.shape != p.shape:
            raise ValueError(f"params_from_jax: {name} has shape {v.shape}, "
                             f"expected {p.shape}")
        out[name] = as_tensor(v)
    return out


def flow_from_jax(params):
    """The JAX package's flow params (``mean``, ``chol``, ``masks`` and a
    list of ``layers``, each ``w1``/``b1``/``w2``/``b2``; numpy arrays or
    anything ``np.asarray`` takes) -> a :class:`Flow` on
    ``settings.device`` in ``settings.floatx``.  Raises ``KeyError`` on a
    missing or extra name and ``ValueError`` on a wrongly shaped value, as
    :func:`params_from_jax` does."""
    from ..bayesian.neutra import Coupling, Flow
    from ..config import as_tensor

    top = {"mean", "chol", "masks", "layers"}
    missing, extra = sorted(top - set(params)), sorted(set(params) - top)
    if missing or extra:
        raise KeyError(f"flow_from_jax: missing {missing}, unexpected {extra}")
    mean = np.asarray(params["mean"])
    if mean.ndim != 1:
        raise ValueError(f"flow_from_jax: mean has shape {mean.shape}, expected (ndim,)")
    ndim, layers = mean.shape[0], list(params["layers"])
    shapes = {"chol": (ndim, ndim), "masks": (len(layers), ndim)}
    for name, shape in shapes.items():
        if np.shape(params[name]) != shape:
            raise ValueError(f"flow_from_jax: {name} has shape {np.shape(params[name])}, "
                             f"expected {shape}")
    couplings = []
    for i, layer in enumerate(layers):
        names = {"w1", "b1", "w2", "b2"}
        missing, extra = sorted(names - set(layer)), sorted(set(layer) - names)
        if missing or extra:
            raise KeyError(f"flow_from_jax: layers[{i}] missing {missing}, unexpected {extra}")
        hidden = np.shape(layer["w1"])[-1]
        want = {"w1": (ndim, hidden), "b1": (hidden,), "w2": (hidden, 2 * ndim),
                "b2": (2 * ndim,)}
        for name, shape in want.items():
            if np.shape(layer[name]) != shape:
                raise ValueError(f"flow_from_jax: layers[{i}].{name} has shape "
                                 f"{np.shape(layer[name])}, expected {shape}")
        couplings.append(Coupling(*(as_tensor(layer[k]) for k in ("w1", "b1", "w2", "b2"))))
    flow = Flow(as_tensor(mean), as_tensor(params["chol"]), as_tensor(params["masks"]), couplings)
    return flow.requires_grad_(False)
