"""Dataset loaders (the PyTorch counterpart of :mod:`g3py_tpu.utils.data`,
subset): the series the reference's recorded experiment was run on, and
the train/test index splits of the ``Experiment`` harness.  The port keeps
its own copy of each file under ``datasets/`` and reads it with numpy (no
pandas)."""

import os

import numpy as np

__all__ = ["data_sunspots", "datasets_path", "random_obs", "uniform_obs"]


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


def random_obs(x, p=0.2, s=1.0, rng=None, plot=False):
    """Random train/test index split: a fraction ``p`` (a count when > 1)
    observed out of the first ``s``-fraction (a count when > 1) of the
    data, from the numpy Generator ``rng`` (a fresh one when None).
    Returns the sorted (observed, test) index arrays."""
    if plot:
        raise NotImplementedError("plotting is not ported yet (ROADMAP Queue 1 item 15)")
    if rng is None:
        rng = np.random.default_rng()
    limit = int(len(x) * s) if s <= 1 else int(s)
    nobs = int(limit * p) if p <= 1 else int(p)
    perm = rng.permutation(limit)
    return np.sort(perm[:nobs]), np.sort(perm[nobs:])


def uniform_obs(x, p=0.2, s=1.0, plot=False):
    """Evenly spaced train/test split over the first ``s``-fraction of the
    data (at least one observed index)."""
    if plot:
        raise NotImplementedError("plotting is not ported yet (ROADMAP Queue 1 item 15)")
    limit = int(len(x) * s) if s <= 1 else int(s)
    nobs = max(int(limit * p) if p <= 1 else int(p), 1)
    obs = np.unique(np.linspace(0, limit - 1, nobs).astype(int))
    return obs, np.setdiff1d(np.arange(limit), obs)
