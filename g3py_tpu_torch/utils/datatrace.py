"""A small column table for MCMC datatraces.

The JAX package's datatrace is a pandas DataFrame (one row per draw of
every chain).  The port keeps no pandas dependency: :class:`Datatrace`
holds equal-length numpy columns in order, under the same names (every
scalar dim of the params, the transformed columns, ``_nchain``,
``_niter``, ``_burnin``, ``_ll``, ``_outlayer``), and offers what the
sampler, the diagnostics and the averaged predictor read from it.
"""

import numpy as np

__all__ = ["Datatrace"]


class Datatrace:
    """Ordered, equal-length numpy columns.

    * ``dt["name"]`` is a column; ``dt[["a", "b"]]`` the (rows, 2) matrix of
      those columns; ``dt[mask]`` (a boolean or integer array) a new
      Datatrace of those rows.
    * ``dt["name"] = values`` adds or replaces a column; :meth:`insert`
      puts a new one at a position; :meth:`copy` and :meth:`iterrows` as
      in pandas."""

    def __init__(self, columns=None):
        self._cols = {}
        for name, values in (columns or {}).items():
            self[name] = values

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
            return np.column_stack([self._cols[k] for k in key])
        return Datatrace({k: v[np.asarray(key)] for k, v in self._cols.items()})

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
        return Datatrace({k: v.copy() for k, v in self._cols.items()})

    def iterrows(self):
        """``(position, row)`` pairs, each row a dict of column -> value
        (pandas' ``iterrows``)."""
        for i in range(len(self)):
            yield i, {k: v[i] for k, v in self._cols.items()}

    def __repr__(self):
        return f"Datatrace({len(self)} rows, columns={self.columns})"
