"""Pairwise metrics (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.metrics`): each metric computes its (N, M) matrix
directly, never an N x M x d broadcast — one matmul where the algebra
allows (ARD_Dot, PSD_Dot), one (N, M) slab per feature otherwise
(:func:`~g3py_tpu_torch.ops.gram.pairwise_sum`).  :class:`Difference` is the
one metric that is (N, M, d) by nature.

A params dict of R rows gives (R, N, M): a (R, d) rate scales (R, N, d)
inputs, and a (R,) scalar broadcasts as (R, 1, 1).
"""

import numpy as np
import torch

from . import Hypers, FlatExp, hval, is_param, slice_dims
from ..config import settings
from ..ops.gram import weighted_sqdist, weighted_dot, pairwise_sum, pairwise_prod

__all__ = [
    "Metric",
    "One",
    "Delta",
    "DeltaEq",
    "DeltaEq2",
    "Minimum",
    "Difference",
    "L1",
    "L2",
    "ARD",
    "ARD_L1",
    "ARD_L2",
    "ARD_Dot",
    "ARD_DotBias",
    "PSD",
    "PSD_Dot",
    "PSD_L2",
]


def _abs_grad_safe(a, b):
    """|a - b| with a pinned zero gradient at ties (the gram diagonal of
    L1, ARD_L1 and OU): tied entries do not move with the rate, and the
    where keeps the derivative of |x| at 0 out of the gradient.  A single
    where suffices: |x| has a finite subgradient, so the masked branch
    cannot produce a NaN."""
    return torch.where(a == b, torch.zeros((), dtype=a.dtype, device=a.device),
                       torch.abs(a - b))


def _scaled(x, rate):
    """Inputs (N, d) times a rate of shape (d,), or (R, N, d) for (R, d)."""
    return x * rate[..., None, :]


class Metric(Hypers):
    """Base pairwise metric.  ``gram(params, x1, x2)`` returns the (N, M)
    matrix over the metric's active dims."""

    def gram(self, params, x1, x2):
        raise NotImplementedError

    def _sliced(self, x1, x2):
        return slice_dims(x1, self.dims), slice_dims(x2, self.dims)

    def input_sensitivity(self, params):
        return torch.ones(self.shape if self.shape else 1, dtype=settings.dtype,
                          device=settings.device)

    def __str__(self):
        return f"{type(self).__name__}[h={self.hypers}]"

    __repr__ = __str__


class One(Metric):
    """Constant 1."""

    def gram(self, params, x1, x2):
        return torch.ones((x1.shape[0], x2.shape[0]), dtype=settings.dtype, device=x1.device)


class Delta(Metric):
    """Count of equal coordinates — the index-match metric of white-noise
    kernels."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        return pairwise_sum(s1, s2, lambda a, b: (a == b).to(settings.dtype))


class DeltaEq(Metric):
    """Count of coordinates where both points equal ``eq`` (KernelEquals,
    multi-output coregionalization)."""

    def gram(self, params, x1, x2, eq=0):
        s1, s2 = self._sliced(x1, x2)
        return pairwise_sum(s1, s2, lambda a, b: ((a == eq) & (b == eq)).to(settings.dtype))


class DeltaEq2(Metric):
    """Symmetric two-index match: (a, b) = (eq1, eq2) or (eq2, eq1)."""

    def gram(self, params, x1, x2, eq1=0, eq2=0):
        s1, s2 = self._sliced(x1, x2)

        def elem(a, b):
            m1 = ((a == eq1) & (b == eq2)).to(settings.dtype)
            m2 = ((a == eq2) & (b == eq1)).to(settings.dtype)
            return m1 + m2

        return pairwise_sum(s1, s2, elem)


class Minimum(Metric):
    """prod_d min(x1_d, x2_d) — the Brownian-motion covariance."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        return pairwise_prod(s1, s2, torch.minimum)


class Difference(Metric):
    """Signed per-dim difference, (N, M, d) by nature; the periodic kernels
    loop over the features instead of building it."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        return s1[:, None, :] - s2[None, :, :]


class L1(Metric):
    """sum_d |x1_d - x2_d|."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        return pairwise_sum(s1, s2, _abs_grad_safe)


class L2(Metric):
    """0.5 * sum_d (x1_d - x2_d)^2."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        return 0.5 * weighted_sqdist(s1, s2)


class ARD(Metric):
    """Base ARD metric: one positive ``rate`` per active dim."""

    def __init__(self, x=None, name=None, rate=None):
        super().__init__(x, name)
        self.rate = rate

    def check_hypers(self, parent=""):
        self.rate = self._param(self.rate, parent + "rate", FlatExp(), shape=self.shape)

    def input_sensitivity(self, params):
        return super().input_sensitivity(params) * hval(self.rate, params) ** 2


class ARD_L1(ARD):
    """sum_d |x1_d - x2_d| rate_d; rate > 0, so |a - b| r = |a r - b r|."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        r = hval(self.rate, params)
        return pairwise_sum(_scaled(s1, r), _scaled(s2, r), _abs_grad_safe)

    def default_hypers(self, x=None, y=None):
        if not is_param(self.rate):
            return {}
        spacing = np.maximum(np.abs(np.diff(x, axis=0)).mean(axis=0), 1e-6)
        return {self.rate: 1.0 / spacing}

    def input_sensitivity(self, params):
        return Metric.input_sensitivity(self, params) * hval(self.rate, params)


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


class ARD_Dot(ARD):
    """sum_d x1_d x2_d rate_d^2, one matmul."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        r = hval(self.rate, params)
        return weighted_dot(_scaled(s1, r), _scaled(s2, r))

    def default_hypers(self, x=None, y=None):
        if not is_param(self.rate):
            return {}
        return {
            self.rate: 1.0 / (np.sqrt(np.abs(x)).mean(axis=0) / np.abs(y).mean(axis=0))
        }


class ARD_DotBias(ARD_Dot):
    """bias + ARD_Dot."""

    def __init__(self, x=None, name=None, rate=None, bias=None):
        super().__init__(x, name, rate)
        self.bias = bias

    def check_hypers(self, parent=""):
        super().check_hypers(parent)
        self.bias = self._param(self.bias, parent + "bias", FlatExp())

    def gram(self, params, x1, x2):
        return hval(self.bias, params)[..., None, None] + super().gram(params, x1, x2)

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.bias):
            out[self.bias] = np.abs(y).mean() / np.abs(x).mean()
        if is_param(self.rate):
            out[self.rate] = np.sqrt(np.abs(y)).mean(axis=0) / np.abs(x).mean(axis=0)
        return out


class PSD(Metric):
    """Low-rank-plus-diagonal Mahalanobis structure
    M = directions^T directions + diag(rate^2), directions of shape (p, d)."""

    def __init__(self, x=None, p=1, name=None, rate=None, directions=None):
        super().__init__(x, name)
        self.rate = rate
        self.directions = directions
        self.p = p

    def check_hypers(self, parent=""):
        self.rate = self._param(self.rate, parent + "rate", FlatExp(), shape=self.shape)
        self.directions = self._param(
            self.directions, parent + "directions", FlatExp(), shape=(self.p, self.shape))

    def _m(self, params):
        d = hval(self.directions, params)
        r = hval(self.rate, params)
        return torch.matmul(d.transpose(-1, -2), d) + torch.diag_embed(r ** 2)

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.rate):
            out[self.rate] = 1.0 / (
                np.sqrt(np.abs(x)).mean(axis=0) / np.abs(y).mean(axis=0))
        if is_param(self.directions):
            out[self.directions] = np.zeros(self.directions.shape, dtype=settings.floatx)
        return out


class PSD_Dot(PSD):
    """x1 M x2^T."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        return torch.matmul(torch.matmul(s1, self._m(params)), s2.transpose(-1, -2))


class PSD_L2(PSD):
    """0.5 (x1-x2)^T M (x1-x2).  With M = A^T A, A = [directions;
    diag(rate)], this is half the squared distance of the mapped points
    x A^T, summed feature by feature: no ``q11 + q22 - 2 x1 M x2^T``
    cancellation (the JAX package's form, whose float32 rounding grows
    with |x|^2), and an exact 0 on the diagonal."""

    def gram(self, params, x1, x2):
        s1, s2 = self._sliced(x1, x2)
        d = hval(self.directions, params)
        a = torch.cat([d, torch.diag_embed(hval(self.rate, params))], dim=-2)
        z1 = torch.matmul(s1, a.transpose(-1, -2))
        z2 = torch.matmul(s2, a.transpose(-1, -2))
        return 0.5 * pairwise_sum(z1, z2, lambda u, v: (u - v) ** 2)
