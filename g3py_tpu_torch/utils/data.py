"""Dataset loaders (the PyTorch counterpart of :mod:`g3py_tpu.utils.data`,
subset): the series the reference's recorded experiment was run on.  The
port keeps its own copy of each file under ``datasets/`` and reads it with
numpy (no pandas)."""

import os

import numpy as np

__all__ = ["data_sunspots", "datasets_path"]


def datasets_path(filename):
    """Path of a bundled dataset file."""
    return os.path.join(os.path.dirname(__file__), "datasets", filename)


def data_sunspots():
    """Yearly sunspot activity, annual SIDC means 1700-2008: ``(x, y)`` with
    x = 0..308 (the positional index) and y = SUNACTIVITY (float64), as the
    JAX package returns them."""
    table = np.loadtxt(datasets_path("sunspots.csv"), delimiter=",", skiprows=1)
    y = table[:, 1]
    return np.arange(len(y)), y
