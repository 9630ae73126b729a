"""Checkpoints of params dicts and chains (the PyTorch counterpart of
:mod:`g3py_tpu.utils.checkpoint`).

A ``.npz`` path is numpy's archive of a flat dict of arrays, byte for byte
what the JAX package writes for the same arrays: either package loads the
other's.  Any other path is a directory that holds that same archive
(``checkpoint.npz``): the JAX package writes an orbax checkpoint there, and
orbax imports JAX, which the port never does (ROADMAP Queue 3 lists this
deliberate difference).  Tensors are saved from the host, whatever device
they lived on; a :class:`~g3py_tpu_torch.utils.datatrace.Datatrace` is saved
as its columns; a nested dict's keys are joined by ``/`` in the archive and
split again on load.
"""

import os
import shutil

import numpy as np

from . import DictObj
from .datatrace import Datatrace

__all__ = ["save_checkpoint", "load_checkpoint"]

#: the archive inside a directory checkpoint
ARCHIVE = "checkpoint.npz"


def _flat(tree, prefix=""):
    """``{key: host array}`` of a (nested) dict of arrays or tensors."""
    if isinstance(tree, Datatrace):
        tree = {c: tree[c] for c in tree.columns}
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, Datatrace)):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                               else np.asarray(v))
    return out


def _nested(flat):
    out = DictObj()
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, DictObj())
        node[leaf] = v
    return out


def save_checkpoint(tree, path):
    """Save a params/chain dict (or a Datatrace) to ``path``: a ``.npz``
    archive, or a directory holding one (replaced when it exists).
    Returns the path written."""
    flat = _flat(tree)
    if path.endswith(".npz"):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(path, **flat)
        return path
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    np.savez(os.path.join(path, ARCHIVE), **flat)
    return path


def load_checkpoint(path):
    """Inverse of :func:`save_checkpoint`: a DictObj of host arrays (nested
    where the saved dict was)."""
    archive = path if path.endswith(".npz") else os.path.join(os.path.abspath(path), ARCHIVE)
    with np.load(archive) as f:
        return _nested({k: f[k] for k in f.files})
