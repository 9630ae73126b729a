"""Dataset loaders and observation splitters (the PyTorch counterpart of
:mod:`g3py_tpu.utils.data`).

The port keeps its own copy of each file it reads under ``datasets/`` and
reads it with numpy or ``csv`` (no pandas): the same values and dtypes as
the JAX package's pandas readers, and a :class:`~g3py_tpu_torch.utils.
datatrace.Datatrace` where the JAX package returns a DataFrame
(``dataframe=True``, :func:`data_rivers`, :func:`load_csv`).  ``co2`` and
``engel`` come from statsmodels in the reference; like the JAX package
without statsmodels, the port returns their synthetic surrogates with a
warning and downloads nothing.
"""

import csv
import os
import warnings

import numpy as np

from .datatrace import Datatrace

__all__ = ["save_csv", "load_csv", "datasets_path", "data_sunspots", "data_co2", "data_engel",
           "data_heart", "data_eurusd", "data_abalone", "data_creep", "data_ailerons",
           "data_rivers", "random_obs", "uniform_obs"]

_DATASETS = os.path.join(os.path.dirname(__file__), "datasets")


def datasets_path(filename=None):
    """The directory of the bundled datasets (``$G3PY_DATASETS`` first, when
    it exists); with ``filename``, the first of them that holds the file
    (None when none does)."""
    for c in (os.environ.get("G3PY_DATASETS"), _DATASETS):
        if c and os.path.isdir(c) and (filename is None
                                       or os.path.isfile(os.path.join(c, filename))):
            return c
    return None


def _file(name):
    path = datasets_path(name)
    if path is None:
        raise FileNotFoundError(f"dataset {name!r} not found under $G3PY_DATASETS or "
                                f"{_DATASETS}: the files ship with the package")
    return os.path.join(path, name)


def _warn_synthetic(name):
    warnings.warn(f"dataset {name!r} not found; returning a SYNTHETIC surrogate with "
                  "matching shapes (G3PY_SYNTHETIC_DATA=1). Results will not match the "
                  "reference's.", stacklevel=3)


def data_sunspots():
    """Yearly sunspot activity, annual SIDC means 1700-2008: ``(x, y)`` with
    x = 0..308 (the positional index) and y = SUNACTIVITY (float64), as the
    JAX package returns them."""
    table = np.loadtxt(_file("sunspots.csv"), delimiter=",", skiprows=1)
    y = table[:, 1]
    return np.arange(len(y)), y


def data_co2():
    """Mauna-Loa CO2: statsmodels' series in the reference; its synthetic
    surrogate (2225 weekly points), with a warning, as the JAX package
    returns it without statsmodels."""
    _warn_synthetic("co2")
    x = np.arange(2225, dtype=np.float32)
    return x, (315 + 0.004 * x + 3 * np.sin(2 * np.pi * x / 52.0)).astype(np.float32)


def data_engel():
    """Engel food-expenditure incomes: statsmodels' data in the reference;
    the synthetic surrogate (235 sorted lognormal incomes), with a warning,
    as the JAX package returns it without statsmodels."""
    _warn_synthetic("engel")
    rng = np.random.default_rng(7)
    return np.arange(235), np.sort(rng.lognormal(6.5, 0.5, 235)).astype(np.float32)


def _column(name):
    """One float32 value a line: (positional index, (n, 1) values)."""
    v = np.loadtxt(_file(name), dtype=np.float32, ndmin=2)
    return np.arange(len(v)), v


def data_heart():
    """Heart-rate series, 1800 points: ``(index, (1800, 1) float32)``."""
    return _column("hr2.txt")


def data_eurusd():
    """EURUSD series, 721 points: ``(index, (721, 1) float32)``."""
    return _column("EURUSD-1401-1510.txt")


_ABALONE_NAMES = ["Sex", "Length", "Diam", "Height", "Whole", "Shucked", "Viscera", "Shell",
                  "Rings"]


def data_abalone(dataframe=False, raw=False):
    """UCI abalone, 4177 x 9.  Unless ``raw``, Sex is 1.0 for M and 0.0
    otherwise.  ``(x (4177, 8) float32, y (4177,) float32)``, or with
    ``dataframe`` the Datatrace of the columns (Rings int64, the rest
    float64)."""
    with open(_file("abalone.data")) as f:
        rows = list(csv.reader(f))
    cols = {"Sex": np.array([r[0] for r in rows], dtype=object)}
    for j, name in enumerate(_ABALONE_NAMES[1:-1], start=1):
        cols[name] = np.array([float(r[j]) for r in rows])
    cols["Rings"] = np.array([int(r[-1]) for r in rows], dtype=np.int64)
    if not raw:
        cols["Sex"] = (cols["Sex"] == "M") * 1.0
    dt = Datatrace(cols)
    if dataframe:
        return dt
    x = np.stack([cols[k] for k in _ABALONE_NAMES[:-1]], axis=1).astype(np.float32)
    return x, cols["Rings"].astype(np.float32)


_CREEP_NAMES = [
    "Lifetime", "Rupture_stress", "Temperature", "Carbon", "Silicon", "Manganese",
    "Phosphorus", "Sulphur", "Chromium", "Molybdenum", "Tungsten", "Nickel", "Copper",
    "Vanadium", "Niobium", "Nitrogen", "Aluminium", "Boron", "Cobalt", "Tantalum", "Oxygen",
    "Normalising_temperature", "Normalising_time", "Cooling_rate", "Tempering_temperature",
    "Tempering_time", "Cooling_rate_tempering", "Annealing_temperature", "Annealing_time",
    "Cooling_rate_annealing", "Rhenium",
]


def _table(name, names, delimiter=None):
    """A numeric table as float32 columns (parsed in float64, then cast, as
    pandas' ``astype('float32')`` does)."""
    values = np.loadtxt(_file(name), delimiter=delimiter, ndmin=2).astype(np.float32)
    return {k: values[:, j] for j, k in enumerate(names)}


def _split(cols, target, dataframe):
    if dataframe:
        return Datatrace(cols)
    x = np.stack([v for k, v in cols.items() if k != target], axis=1).astype(np.float32)
    return x, cols[target].astype(np.float32)


def data_creep(dataframe=False, raw=False):
    """Materials creep-rupture data, 2066 x 31, float32.  Unless ``raw``,
    Tantalum, Cooling_rate_annealing and Rhenium are dropped and
    Rupture_stress is scaled by 0.1 (the target)."""
    cols = _table("creep", _CREEP_NAMES)
    if not raw:
        for k in ("Tantalum", "Cooling_rate_annealing", "Rhenium"):
            del cols[k]
        cols["Rupture_stress"] = cols["Rupture_stress"] * np.float32(1e-1)
    return _split(cols, "Rupture_stress", dataframe)


_AILERONS_NAMES = (
    ["climbRate", "Sgz", "p", "q", "curPitch", "curRoll", "absRoll", "diffClb", "diffRollRate",
     "diffDiffClb"]
    + [f"SeTime{i}" for i in range(1, 15)]
    + [f"diffSeTime{i}" for i in range(1, 15)]
    + ["alpha", "Se", "goal"])


def data_ailerons(dataframe=False, raw=False):
    """F16 ailerons control data, 7154 x 41, float32.  Unless ``raw``, goal
    (the target) is scaled by 1e4 and the even diffSeTime columns are
    dropped."""
    cols = _table("ailerons.data", _AILERONS_NAMES, delimiter=",")
    if not raw:
        cols["goal"] = cols["goal"] * np.float32(1e4)
        for i in range(2, 15, 2):
            del cols[f"diffSeTime{i}"]
    return _split(cols, "goal", dataframe)


def data_rivers():
    """River flows (the exponential of five log series, float32): a
    Datatrace with the columns bmau, bmis, cip, col, mau and the files' row
    labels (1.0, 2.0, ...) as its index."""
    cols, index = {}, None
    for c in ("bmau", "bmis", "cip", "col", "mau"):
        table = np.loadtxt(_file(f"log{c}.csv"), delimiter=",", skiprows=1,
                           converters={0: lambda s: float(s.strip('"'))}, dtype=np.float32)
        index = table[:, 0]
        cols[c] = np.exp(table[:, 1])
    return Datatrace(cols, index=index)


def random_obs(x, p=0.2, s=1.0, rng=None, plot=False):
    """Random train/test index split: a fraction ``p`` (a count when > 1)
    observed out of the first ``s``-fraction (a count when > 1) of the
    data, from the numpy Generator ``rng`` (a fresh one when None).
    Returns the sorted (observed, test) index arrays; ``plot`` is accepted
    and draws nothing, as in the JAX package."""
    if rng is None:
        rng = np.random.default_rng()
    limit = int(len(x) * s) if s <= 1 else int(s)
    nobs = int(limit * p) if p <= 1 else int(p)
    perm = rng.permutation(limit)
    return np.sort(perm[:nobs]), np.sort(perm[nobs:])


def uniform_obs(x, p=0.2, s=1.0, plot=False):
    """Evenly spaced train/test split over the first ``s``-fraction of the
    data (at least one observed index); ``plot`` is accepted and draws
    nothing, as in the JAX package."""
    limit = int(len(x) * s) if s <= 1 else int(s)
    nobs = max(int(limit * p) if p <= 1 else int(p), 1)
    obs = np.unique(np.linspace(0, limit - 1, nobs).astype(int))
    return obs, np.setdiff1d(np.arange(limit), obs)


def _cell(v):
    return repr(float(v)) if isinstance(v, (float, np.floating)) else str(v)


def save_csv(df, file, index_col=0):
    """Write a Datatrace (or a dict of columns) as CSV: a first unnamed
    column of row labels, then the columns, as pandas' ``to_csv`` lays it
    out."""
    dt = df if isinstance(df, Datatrace) else Datatrace(dict(df))
    with open(file, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + dt.columns)
        cols = [dt[c] for c in dt.columns]
        for i, label in enumerate(dt.index):
            w.writerow([_cell(label)] + [_cell(c[i]) for c in cols])


def _parse(values):
    """A CSV column as int64, then float64, then bool, else strings (the
    order pandas' reader infers them in)."""
    for cast in (np.int64, np.float64):
        try:
            return np.array([cast(v) for v in values])
        except ValueError:
            pass
    if set(values) <= {"True", "False"}:
        return np.array([v == "True" for v in values])
    return np.array(values, dtype=object)


def load_csv(file, index_col=0):
    """Read a CSV written by :func:`save_csv` (or pandas) into a Datatrace,
    column ``index_col`` as the row labels (None: no label column)."""
    with open(file, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    cols = {name: _parse([r[j] for r in body]) for j, name in enumerate(header)}
    index = None
    if index_col is not None:
        index = cols.pop(header[index_col])
    return Datatrace(cols, index=index)
