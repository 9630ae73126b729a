"""Pairwise metrics (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.metrics`): each metric computes its (N, M) matrix
directly, never an N x M x d broadcast.  This slice carries the metrics of
exact GP/WGP regression: :class:`ARD_L2` under every stationary kernel and
:class:`Delta` under the noise term."""

import numpy as np

from . import Hypers, FlatExp, hval, is_param, slice_dims
from ..config import settings
from ..ops.gram import weighted_sqdist, pairwise_sum

__all__ = ["Metric", "Delta", "ARD", "ARD_L2"]


class Metric(Hypers):
    """Base pairwise metric.  ``gram(params, x1, x2)`` returns the (N, M)
    matrix over the metric's active dims."""

    def gram(self, params, x1, x2):
        raise NotImplementedError

    def _sliced(self, x1, x2):
        return slice_dims(x1, self.dims), slice_dims(x2, self.dims)

    def __str__(self):
        return f"{type(self).__name__}[h={self.hypers}]"

    __repr__ = __str__


class Delta(Metric):
    """Count of equal coordinates — the index-match metric of white-noise
    kernels."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        return pairwise_sum(s1, s2, lambda a, b: (a == b).to(settings.dtype))


class ARD(Metric):
    """Base ARD metric: one positive ``rate`` per active dim."""

    def __init__(self, x=None, name=None, rate=None):
        super().__init__(x, name)
        self.rate = rate

    def check_hypers(self, parent=""):
        self.rate = self._param(self.rate, parent + "rate", FlatExp(), shape=self.shape)


class ARD_L2(ARD):
    """sum_d (x1_d - x2_d)^2 * 0.5 rate_d^2 — the metric under SE, the
    Materns and RQ."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        return 0.5 * weighted_sqdist(s1, s2, hval(self.rate, params))

    def default_hypers(self, x=None, y=None):
        if not is_param(self.rate):
            return {}
        # clip zero spacing (constant input columns) so the default stays
        # finite instead of tripping the logp guards
        spacing = np.maximum(np.abs(np.diff(x, axis=0)).mean(axis=0), 1e-6)
        return {self.rate: 0.5 / spacing}
