"""A small column table for MCMC datatraces.

The JAX package's datatrace is a pandas DataFrame (one row per draw of
every chain).  The port keeps no pandas dependency: :class:`Datatrace`
holds equal-length numpy columns in order, under the same names (every
scalar dim of the params, the transformed columns, ``_nchain``,
``_niter``, ``_burnin``, ``_ll``, ``_outlayer``), and offers what the
sampler, the diagnostics, the averaged predictor and the datatrace toolkit
(:mod:`g3py_tpu_torch.bayesian.average`) read from it: row labels
(``index``, the row positions of the datatrace a selection came from),
column filters, random and ordered row selections, duplicates and the
column means and medians.
"""

import numpy as np

__all__ = ["Datatrace"]


class Datatrace:
    """Ordered, equal-length numpy columns.

    * ``dt["name"]`` is a column; ``dt[["a", "b"]]`` a Datatrace of those
      columns (``np.asarray`` of it, ``values`` and ``to_numpy()`` are the
      (rows, 2) matrix); ``dt[mask]`` (a boolean or integer array) and
      ``dt[a:b]`` a new Datatrace of those rows.
    * ``dt.iloc[i]`` is row ``i`` as a dict of column -> value;
      ``dt.iloc[a:b:k]`` (or an integer or boolean array) a Datatrace of
      those rows, as in pandas.
    * ``dt["name"] = values`` adds or replaces a column; :meth:`insert`
      puts a new one at a position; :meth:`copy` and :meth:`iterrows` as
      in pandas.
    * ``dt[fn]`` with a callable selects the rows ``fn(dt)`` (a boolean or
      integer array) selects (pandas' ``loc`` with a callable).
    * ``index`` holds the rows' labels: 0..len-1 for a new Datatrace, the
      parent's labels for a row selection."""

    def __init__(self, columns=None, index=None):
        self._cols = {}
        for name, values in (columns or {}).items():
            self[name] = values
        self._index = None if index is None else np.asarray(index)

    @property
    def index(self):
        return np.arange(len(self)) if self._index is None else self._index

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name):
        return name in self._cols

    def _column(self, values):
        values = np.asarray(values)
        if values.ndim != 1 or (self._cols and len(values) != len(self)):
            raise ValueError(f"Datatrace: a column of {len(self)} values is needed, "
                             f"got shape {values.shape}")
        return values

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, list):
            missing = [k for k in key if k not in self._cols]
            if missing:
                raise KeyError(f"Datatrace: no columns {missing}")
            return Datatrace({k: self._cols[k] for k in key}, index=self._index)
        if callable(key):
            key = key(self)
        if isinstance(key, slice):
            key = np.arange(len(self))[key]
        key = np.asarray(key)
        return Datatrace({k: v[key] for k, v in self._cols.items()}, index=self.index[key])

    @property
    def iloc(self):
        """Positional rows: ``iloc[i]`` a dict of column -> value,
        ``iloc[slice or array]`` a Datatrace of those rows."""
        return _ILoc(self)

    def to_numpy(self, dtype=None):
        """The (rows, columns) matrix of every column in order."""
        cols = list(self._cols.values())
        out = np.column_stack(cols) if cols else np.zeros((0, 0))
        return out if dtype is None else out.astype(dtype, copy=False)

    values = property(to_numpy)

    def __array__(self, dtype=None, copy=None):
        return self.to_numpy(dtype)

    def __setitem__(self, name, values):
        self._cols[name] = self._column(values)

    def insert(self, position, name, values):
        """Add column ``name`` at ``position`` of the column order."""
        if name in self._cols:
            raise ValueError(f"Datatrace: column {name!r} exists")
        items = list(self._cols.items())
        items.insert(position, (name, self._column(values)))
        self._cols = dict(items)

    def copy(self):
        """A Datatrace of copies of the columns."""
        return Datatrace({k: v.copy() for k, v in self._cols.items()}, index=self._index)

    # -- column filters ----------------------------------------------------
    def drop(self, columns, axis=1):
        """A Datatrace without ``columns`` (a name or a list of names)."""
        if axis != 1:
            raise ValueError("Datatrace.drop drops columns only (axis=1)")
        columns = [columns] if isinstance(columns, str) else list(columns)
        missing = [c for c in columns if c not in self._cols]
        if missing:
            raise KeyError(f"Datatrace.drop: no columns {missing}")
        return Datatrace({k: v for k, v in self._cols.items() if k not in columns},
                         index=self._index)

    def filter(self, items=None, like=None, regex=None):
        """The columns named in ``items`` (in that order, absent ones
        skipped), or whose name contains ``like``, or matches ``regex``
        (``re.search``), as pandas' ``filter``: exactly one of them."""
        import re

        if sum(a is not None for a in (items, like, regex)) != 1:
            raise TypeError("Datatrace.filter takes exactly one of items, like, regex")
        if items is not None:
            names = [c for c in items if c in self._cols]
        elif like is not None:
            names = [c for c in self._cols if like in c]
        else:
            names = [c for c in self._cols if re.search(regex, c)]
        return Datatrace({k: self._cols[k] for k in names}, index=self._index)

    # -- row selections ----------------------------------------------------
    def sample(self, n, rng=None):
        """``n`` rows drawn without replacement in draw order, from numpy's
        ``RandomState`` ``rng`` (numpy's global one when None, as pandas'
        ``sample`` draws)."""
        rng = np.random.mtrand._rand if rng is None else rng
        return self[rng.choice(len(self), size=n, replace=False)]

    def drop_duplicates(self, subset=None):
        """The first row of every set of rows equal on ``subset`` (every
        column when None), in row order."""
        cols = self.columns if subset is None else list(subset)
        seen, keep = set(), []
        for i, row in enumerate(zip(*(self._cols[c].tolist() for c in cols))):
            if row not in seen:
                seen.add(row)
                keep.append(i)
        return self[np.asarray(keep, dtype=np.int64)]

    def _ordered(self, n, column, largest):
        v = np.asarray(self._cols[column], dtype=np.float64)
        pos = np.flatnonzero(~np.isnan(v))
        order = np.argsort(-v[pos] if largest else v[pos], kind="stable")
        return self[pos[order[:n]]]

    def nlargest(self, n, column):
        """The ``n`` rows of largest ``column`` in descending order, ties
        in row order (pandas' ``keep='first'``); NaN rows left out."""
        return self._ordered(n, column, True)

    def nsmallest(self, n, column):
        """The ``n`` rows of smallest ``column`` in ascending order."""
        return self._ordered(n, column, False)

    def sort_values(self, by, ascending=True):
        """Rows ordered by column ``by`` with pandas' default rule (NaN
        last; a descending order reverses an ascending sort of the reversed
        rows, so that ties keep their row order)."""
        v = np.asarray(self._cols[by], dtype=np.float64)
        pos = np.flatnonzero(~np.isnan(v))
        vals = v[pos]
        if not ascending:
            vals, pos = vals[::-1], pos[::-1]
        order = pos[np.argsort(vals, kind="quicksort")]
        if not ascending:
            order = order[::-1]
        return self[np.concatenate([order, np.flatnonzero(np.isnan(v))])]

    # -- reductions ----------------------------------------------------------
    def _numeric(self):
        return {k: v for k, v in self._cols.items()
                if v.dtype.kind in "biuf"}

    def mean(self, numeric_only=True):
        """The mean of every numeric (bool, integer or float) column, a
        dict in column order."""
        return {k: float(np.mean(v.astype(np.float64))) for k, v in self._numeric().items()}

    def median(self, numeric_only=True):
        """The median of every numeric column, NaN left out, a dict in
        column order."""
        return {k: float(np.nanmedian(v.astype(np.float64))) for k, v in self._numeric().items()}

    @classmethod
    def from_rows(cls, rows, columns, index=None):
        """A Datatrace of ``rows`` (mappings of column -> value) over
        ``columns``; a column a row lacks is NaN there (float64 columns
        unless every value is of one other numpy kind)."""
        data = {}
        for c in columns:
            vals = [r.get(c, np.nan) for r in rows]
            try:
                arr = np.asarray(vals)
            except ValueError:  # values of several shapes
                arr = np.empty(0, dtype=object)
            if arr.dtype.kind not in "biufUS" or arr.ndim != 1:
                arr = np.empty(len(vals), dtype=object)
                for i, v in enumerate(vals):
                    arr[i] = v
            data[c] = arr
        return cls(data, index=index)

    def iterrows(self):
        """``(position, row)`` pairs, each row a dict of column -> value
        (pandas' ``iterrows``)."""
        for i in range(len(self)):
            yield i, {k: v[i] for k, v in self._cols.items()}

    def __repr__(self):
        return f"Datatrace({len(self)} rows, columns={self.columns})"


class _ILoc:
    """``Datatrace.iloc``: pandas' positional row access."""

    def __init__(self, dt):
        self._dt = dt

    def __getitem__(self, key):
        dt = self._dt
        if isinstance(key, (int, np.integer)):
            i = range(len(dt))[key]  # negative positions, IndexError past the end
            return {k: v[i] for k, v in dt._cols.items()}
        if isinstance(key, slice):
            return dt[key]
        key = np.asarray(key)
        if key.dtype == bool:
            key = np.flatnonzero(key)
        return dt[key]
