"""The reference's recorded experiment, without pandas (the PyTorch
counterpart of the parts of :mod:`g3py_tpu.utils.reference_io` that the
parity oracle needs).

The JAX package reads the recorded sunsets experiment from the reference's
pickled DataFrames.  The port reads the same records from
``datasets/sunsets_oracle.json`` (written once from those pickles by
``python tests/test_torch_parity.py --regen``, and held equal to them by
that test):

* ``rows``: every result row of the experiment — ``model``, ``n_sim``,
  ``params`` (transformed space, float32 values), ``scores_obs`` and
  ``scores_test`` (the reference's own float64 records);
* ``simulations``: each ``n_sim``'s ``obs`` and ``test`` index arrays.
"""

import json

import numpy as np

from .data import _file

__all__ = ["load_oracle", "transformed_to_natural", "natural_to_transformed"]


def load_oracle(path=None):
    """``(rows, simulations)`` of the recorded experiment: a list of row
    dicts (params as float32 arrays) and a dict ``n_sim -> {"obs", "test"}``
    of int64 index arrays."""
    with open(path or _file("sunsets_oracle.json")) as fh:
        data = json.load(fh)
    rows = [dict(row, params={k: np.asarray(v, np.float32) for k, v in row["params"].items()})
            for row in data["rows"]]
    sims = {int(k): {s: np.asarray(v, np.int64) for s, v in sim.items()}
            for k, sim in data["simulations"].items()}
    return rows, sims


def transformed_to_natural(params):
    """A reference transformed-space params dict in the natural space: the
    log-transformed positives (``<name>_log_`` or ``<name>_log__``) are
    exponentiated under the natural name; score annotations (``_...``) are
    dropped.  Values pass through float32 first, as the reference's
    pipeline held them."""
    out = {}
    for key, val in params.items():
        if key.startswith("_"):
            continue
        val = np.asarray(val, dtype=np.float32)
        if key.endswith("_log_"):
            out[key[: -len("_log_")]] = np.exp(val)
        elif key.endswith("_log__"):
            out[key[: -len("_log__")]] = np.exp(val)
        else:
            out[key] = val
    return out


#: hyper-name suffixes the reference declares with a log transform
_LOG_TRANSFORMED_SUFFIXES = (
    "_var", "_Var", "_rate", "_Scales", "_scale", "_power", "_alpha",
    "_freq", "_a", "_b", "_w", "_degree", "_nu",
)


def natural_to_transformed(params):
    """Inverse of :func:`transformed_to_natural`, by the reference's naming
    convention: the suffixes in ``_LOG_TRANSFORMED_SUFFIXES`` carry log
    transforms; anything else passes through."""
    out = {}
    for key, val in params.items():
        val = np.asarray(val, dtype=np.float32)
        if key.endswith(_LOG_TRANSFORMED_SUFFIXES):
            out[key + "_log_"] = np.log(val)
        else:
            out[key] = val
    return out
