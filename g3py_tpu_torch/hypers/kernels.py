"""Covariance kernels with operator algebra (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.kernels`): the same class hierarchy (dot,
stationary, periodic and index kernels), the same ``+``/``*`` algebra
building composites that merge the parts' hypers, and the same data-driven
defaults; every ``cov`` is a function of a params dict.

:meth:`KernelStationary.cov` sends SE, MAT32, MAT52 and RQ on an ARD_L2
metric with a Param rate through
:func:`g3py_tpu_torch.ops.stationary_gram.stationary_gram`, which launches
the hand-written CUDA kernel for CUDA tensors (and computes its plain
version for CPU tensors) — inside a sum, product, scale or shift too, one
launch per such factor.  A subclass that overrides ``k`` (OU's exp on the
ARD_L1 metric included) or a fixed rate takes the generic path: the kernel
bakes in the family's own ``k`` on ARD_L2.  The periodic kernels go one
feature slab at a time (:func:`~g3py_tpu_torch.ops.gram.pairwise_sum`,
:func:`~g3py_tpu_torch.ops.gram.pairwise_prod`), never an N x M x d tensor.

A params dict of R rows gives (R, m, n) grams (a kernel with no Param,
such as ``VAR(var=2.0)`` or ``NIL``, stays (m, n) and broadcasts); the
rows' fused grams share one launch.  ``SIN`` is the PSD exp-sin^2 form and
``NN`` Williams' arcsine kernel with diagonal normalizers, as in the JAX
package.
"""

import numpy as np
import torch

from . import Hypers, FlatExp, hval, is_param, slice_dims
from ..config import settings
from ..ops.gram import pairwise_sum, pairwise_prod
from ..ops.stationary_gram import stationary_gram
from .metrics import (Delta, DeltaEq, DeltaEq2, Minimum, One, Difference, ARD_Dot,
                      ARD_DotBias, ARD_L1, ARD_L2)

__all__ = [
    "Kernel",
    "KernelDot",
    "KernelStationary",
    "KernelOperation",
    "KernelComposition",
    "KernelScale",
    "KernelShift",
    "KernelProd",
    "KernelSum",
    "KernelMax",
    "KernelEquals",
    "KernelEquals2",
    "BW",
    "VAR",
    "NIL",
    "LIN",
    "POL",
    "NN",
    "KernelNoise",
    "WN",
    "RQ",
    "MAT32",
    "MAT52",
    "KernelStationaryExponential",
    "OU",
    "SE",
    "KernelPeriodic",
    "COS",
    "SIN",
    "SINC",
    "SM",
]

pi = np.pi
pi2 = np.pi ** 2


def _scalar(h, params):
    """A scalar hyper as a tensor that broadcasts over (m, n) grams: () or,
    for R rows, (R, 1, 1)."""
    return hval(h, params)[..., None, None]


def _full(x1, x2, value):
    return torch.full((x1.shape[0], x2.shape[0]), value, dtype=settings.dtype,
                      device=x1.device)


class Kernel(Hypers):
    """Base kernel: amplitude ``var`` times a metric.  ``cov(params, x1,
    x2=None)`` is the gram entry point; ``x2=None`` means the square form."""

    def __init__(self, x=None, name=None, metric=Delta, var=None):
        self.metric = metric(x) if isinstance(metric, type) else metric
        super().__init__(x, name)
        self.var = var

    def check_hypers(self, parent=""):
        self.var = self._param(self.var, parent + self.name + "_var", FlatExp())
        self.metric.check_hypers(parent + self.name + "_")
        self.hypers += self.metric.hypers

    def check_dims(self, x=None):
        super().check_dims(x)
        self.metric.check_dims(x)

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.var):
            out[self.var] = np.asarray(np.var(y), dtype=settings.floatx)
        if self.metric is not None:
            out.update(self.metric.default_hypers(x, y))
        return out

    def default_hypers_dims(self, x=None, y=None):
        out = {}
        if is_param(self.var):
            out[self.var] = np.asarray(np.var(y), dtype=settings.floatx)
        if self.metric is not None:
            out.update(self.metric.default_hypers_dims(x, y))
        return out

    def input_sensitivity(self, params):
        return hval(self.var, params)[..., None] * self.metric.input_sensitivity(params)

    def cov(self, params, x1, x2=None):
        raise NotImplementedError

    # -- algebra: a kernel with a kernel gives a product or a sum, with
    # anything else a scale or a shift
    def __mul__(self, other):
        if isinstance(other, Kernel):
            return KernelProd(self, other)
        return KernelScale(self, other)

    __imul__ = __mul__

    def __rmul__(self, other):
        if isinstance(other, Kernel):
            return KernelProd(other, self)
        return KernelScale(self, other)

    def __add__(self, other):
        if isinstance(other, Kernel):
            return KernelSum(self, other)
        return KernelShift(self, other)

    __iadd__ = __add__

    def __radd__(self, other):
        if isinstance(other, Kernel):
            return KernelSum(other, self)
        return KernelShift(self, other)

    def __str__(self):
        return f"{type(self).__name__}[m={self.metric},h={self.hypers}]"

    __repr__ = __str__


class KernelDot(Kernel):
    """var * metric-gram (the dot-product family)."""

    def __init__(self, x=None, name=None, metric=ARD_Dot, var=None):
        super().__init__(x, name, metric, var)

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        return _scalar(self.var, params) * self.metric.gram(params, x1, x2)


class KernelStationary(Kernel):
    """var * k(metric-gram)."""

    #: key into ops.stationary_gram.KINDS when this family has the fused
    #: kernel (SE/MAT32/MAT52/RQ on ARD_L2)
    _gram_kind = None

    def __init__(self, x=None, name=None, metric=ARD_L2, var=None):
        super().__init__(x, name, metric, var)

    def k(self, params, d):
        return d

    def _gram_extra(self, params):
        return None

    def _gram_dispatchable(self):
        """The fused gram is valid only while this instance still uses the
        family's own k() on an ARD_L2 metric with a Param rate: a subclass
        overriding k, another metric or a fixed rate gets the generic
        path."""
        kind = self._gram_kind
        if kind is None or type(self.metric) is not ARD_L2 \
                or not is_param(self.metric.rate):
            return None
        owner_k = _GRAM_K_OWNERS.get(kind)
        if owner_k is None or type(self).k is not owner_k:
            return None
        return kind

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        kind = self._gram_dispatchable()
        if kind is not None:
            s1, s2 = self.metric._sliced(x1, x2)
            return stationary_gram(kind, s1, s2, hval(self.metric.rate, params),
                                   hval(self.var, params), self._gram_extra(params))
        return _scalar(self.var, params) * self.k(params, self.metric.gram(params, x1, x2))


# ---------------------------------------------------------------------------
# composites
# ---------------------------------------------------------------------------


class KernelOperation(Kernel):
    """kernel (op) scalar element."""

    def __init__(self, _k, _element):
        self.k_inner = _k
        self.element = _element
        self.hypers = []
        self.potential = None
        self.op = "op"

    def check_hypers(self, parent=""):
        self.k_inner.check_hypers(parent=parent)
        self.hypers = list(self.k_inner.hypers)

    def check_dims(self, x=None):
        self.k_inner.check_dims(x)

    def default_hypers_dims(self, x=None, y=None):
        return self.k_inner.default_hypers_dims(x, y)

    def potential_logp(self, params):
        parts = [p for p in (super().potential_logp(params),
                             self.k_inner.potential_logp(params)) if p is not None]
        return sum(parts[1:], parts[0]) if parts else None

    def input_sensitivity(self, params):
        return self.k_inner.input_sensitivity(params)

    def has_potential(self):
        return (getattr(self, "potential", None) is not None
                or self.k_inner.has_potential())

    @property
    def name(self):
        return f"{self.element} {self.op} {self.k_inner.name}"

    def __str__(self):
        return f"{self.element} {self.op} {self.k_inner}"

    __repr__ = __str__


class KernelComposition(Kernel):
    """kernel (op) kernel."""

    def __init__(self, _k1, _k2):
        self.k1 = _k1
        self.k2 = _k2
        self.hypers = []
        self.potential = None
        self.op = "op"

    def check_hypers(self, parent=""):
        self.k1.check_hypers(parent=parent)
        self.k2.check_hypers(parent=parent)
        self.hypers = list(self.k1.hypers) + list(self.k2.hypers)

    def check_dims(self, x=None):
        self.k1.check_dims(x)
        self.k2.check_dims(x)

    def default_hypers_dims(self, x=None, y=None):
        return {
            **self.k1.default_hypers_dims(x, y),
            **self.k2.default_hypers_dims(x, y),
        }

    def potential_logp(self, params):
        parts = [p for p in (super().potential_logp(params),
                             self.k1.potential_logp(params),
                             self.k2.potential_logp(params)) if p is not None]
        if not parts:
            return None
        return sum(parts[1:], parts[0])

    def input_sensitivity(self, params):
        return self.k1.input_sensitivity(params) + self.k2.input_sensitivity(params)

    def has_potential(self):
        return (getattr(self, "potential", None) is not None
                or self.k1.has_potential() or self.k2.has_potential())

    @property
    def name(self):
        return f"{self.k1.name} {self.op} {self.k2.name}"

    def __str__(self):
        return f"{self.k1} {self.op} {self.k2}"

    __repr__ = __str__


class KernelScale(KernelOperation):
    def __init__(self, _k, _element):
        super().__init__(_k, _element)
        self.op = "*"

    def cov(self, params, x1, x2=None):
        return _scalar(self.element, params) * self.k_inner.cov(params, x1, x2)


class KernelShift(KernelOperation):
    def __init__(self, _k, _element):
        super().__init__(_k, _element)
        self.op = "+"

    def cov(self, params, x1, x2=None):
        return _scalar(self.element, params) + self.k_inner.cov(params, x1, x2)


class KernelProd(KernelComposition):
    def __init__(self, _k1, _k2):
        super().__init__(_k1, _k2)
        # if neither side carries an amplitude the product would count one
        # twice: pin k2's to 1
        if hasattr(self.k1, "var") and hasattr(self.k2, "var"):
            if self.k1.var is None and self.k2.var is None:
                self.k2.var = 1.0
        self.op = "*"

    def cov(self, params, x1, x2=None):
        return self.k1.cov(params, x1, x2) * self.k2.cov(params, x1, x2)


class KernelSum(KernelComposition):
    def __init__(self, _k1, _k2):
        super().__init__(_k1, _k2)
        self.op = "+"

    def cov(self, params, x1, x2=None):
        return self.k1.cov(params, x1, x2) + self.k2.cov(params, x1, x2)


class KernelMax(KernelComposition):
    """The elementwise maximum of two grams; at a tie (the diagonal of two
    kernels with one amplitude) each side takes half the gradient, as
    JAX's maximum gives it."""

    def __init__(self, _k1, _k2):
        super().__init__(_k1, _k2)
        self.op = "max"

    def cov(self, params, x1, x2=None):
        return torch.maximum(self.k1.cov(params, x1, x2), self.k2.cov(params, x1, x2))


# ---------------------------------------------------------------------------
# index kernels (multi-output / coregionalization)
# ---------------------------------------------------------------------------


class KernelEquals(Kernel):
    """Indicator kernel on an index column."""

    def __init__(self, x=None, name=None, metric=DeltaEq, eq=0):
        super().__init__(x, name, metric, 1.0)
        self.eq = eq

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        return self.metric.gram(params, x1, x2, self.eq)


class KernelEquals2(Kernel):
    """Symmetric two-index indicator."""

    def __init__(self, x=None, name=None, metric=DeltaEq2, eq1=0, eq2=0):
        super().__init__(x, name, metric, 1.0)
        self.eq1 = eq1
        self.eq2 = eq2

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        return self.metric.gram(params, x1, x2, self.eq1, self.eq2)


# ---------------------------------------------------------------------------
# dot-kernel zoo
# ---------------------------------------------------------------------------


class BW(KernelDot):
    """Brownian motion: var * prod_d min(x1, x2)."""

    def __init__(self, x=None, name=None, metric=Minimum, var=None):
        super().__init__(x, name, metric, var)


class VAR(KernelDot):
    """Constant covariance var."""

    def __init__(self, x=None, name=None, metric=One, var=None):
        super().__init__(x, name, metric, var)

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        return _scalar(self.var, params) * _full(x1, x2, 1.0)


class NIL(KernelDot):
    """Zero kernel."""

    def __init__(self, x=None, name=None, metric=One, var=1):
        super().__init__(x, name, metric, var)

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        return _full(x1, x2, 0.0)


class LIN(KernelDot):
    """Linear kernel: the biased dot product."""

    def __init__(self, x=None, name=None, metric=ARD_DotBias, var=1):
        super().__init__(x, name, metric, var)


class POL(KernelDot):
    """Polynomial kernel: (biased dot)^p."""

    def __init__(self, x=None, p=2, name=None, metric=ARD_DotBias, var=1):
        super().__init__(x, name, metric, var)
        self.p = p

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        return _scalar(self.var, params) * self.metric.gram(params, x1, x2) ** self.p


class NN(KernelDot):
    """Arcsine neural-network kernel (Williams 1998) with per-point
    diagonal normalizers: var * arcsin(2 g12 / sqrt((1 + 2 g11)(1 + 2 g22))),
    the argument clipped to [-1, 1]."""

    def __init__(self, x=None, name=None, metric=ARD_DotBias, var=None):
        super().__init__(x, name, metric, var)

    def _diag_gram(self, params, x):
        # g(x_i, x_i) for each row: bias + sum_d x_d^2 rate_d^2
        s = slice_dims(x, self.metric.dims)
        r = hval(self.metric.rate, params)
        b = hval(self.metric.bias, params)
        return b[..., None] + ((s * r[..., None, :]) ** 2).sum(dim=-1)

    def cov(self, params, x1, x2=None):
        same = x2 is None
        if same:
            x2 = x1
        g12 = self.metric.gram(params, x1, x2)
        d1 = self._diag_gram(params, x1)
        d2 = d1 if same else self._diag_gram(params, x2)
        denom = torch.sqrt((1.0 + 2.0 * d1)[..., :, None] * (1.0 + 2.0 * d2)[..., None, :])
        arg = torch.clamp(2.0 * g12 / denom, -1.0, 1.0)
        return _scalar(self.var, params) * torch.arcsin(arg)


# ---------------------------------------------------------------------------
# stationary zoo
# ---------------------------------------------------------------------------


class KernelNoise(KernelStationary):
    """Observation noise: var * I on a square cov, exactly 0 on cross-covs
    (the prior/posterior noise split hinges on this asymmetry)."""

    def __init__(self, x=None, name=None, metric=Delta, var=None):
        super().__init__(x, name, metric, var)

    def cov(self, params, x1, x2=None):
        if x2 is None:
            return _scalar(self.var, params) * torch.eye(
                x1.shape[0], dtype=settings.dtype, device=x1.device)
        return _full(x1, x2, 0.0)


class WN(KernelStationary):
    """White noise: var * I on a square cov, var * delta-match on a cross
    cov."""

    def __init__(self, x=None, name=None, metric=Delta, var=None):
        super().__init__(x, name, metric, var)

    def cov(self, params, x1, x2=None):
        if x2 is None:
            return _scalar(self.var, params) * torch.eye(
                x1.shape[0], dtype=settings.dtype, device=x1.device)
        return _scalar(self.var, params) * self.metric.gram(params, x1, x2)


class RQ(KernelStationary):
    """Rational quadratic: (1 + d/alpha)^-alpha."""

    _gram_kind = "rq"

    def __init__(self, x=None, name=None, metric=ARD_L2, var=None, alpha=None):
        super().__init__(x, name, metric, var)
        self.alpha = alpha

    def _gram_extra(self, params):
        return hval(self.alpha, params)

    def check_hypers(self, parent=""):
        super().check_hypers(parent=parent)
        self.alpha = self._param(self.alpha, parent + self.name + "_alpha", FlatExp())

    def default_hypers(self, x=None, y=None):
        out = super().default_hypers(x, y)
        if is_param(self.alpha):
            out[self.alpha] = np.asarray(1.0, dtype=settings.floatx)
        return out

    def k(self, params, d):
        a = _scalar(self.alpha, params)
        return torch.pow(1.0 + d / a, -a)


class MAT32(KernelStationary):
    """Matern 3/2 on the ARD_L2 metric; the sqrt argument is clamped away
    from zero for a finite lengthscale gradient at the gram diagonal."""

    _gram_kind = "mat32"

    def k(self, params, d):
        d3 = torch.sqrt(torch.clamp(3.0 * d, min=1e-36))
        return (1.0 + d3) * torch.exp(-d3)


class MAT52(KernelStationary):
    """Matern 5/2 (sqrt clamped as in MAT32)."""

    _gram_kind = "mat52"

    def k(self, params, d):
        d5 = torch.sqrt(torch.clamp(5.0 * d, min=1e-36))
        return (1.0 + d5 + 5.0 * d / 3.0) * torch.exp(-d5)


class KernelStationaryExponential(KernelStationary):
    """k(d) = exp(-d)."""

    def k(self, params, d):
        return torch.exp(-d)


class OU(KernelStationaryExponential):
    """Ornstein-Uhlenbeck: exp(-ARD_L1).  It inherits SE's k() but not its
    metric, so it never takes the fused gram."""

    def __init__(self, x=None, name=None, metric=ARD_L1, var=None):
        super().__init__(x, name, metric, var)


class SE(KernelStationaryExponential):
    """Squared exponential: exp(-ARD_L2)."""

    _gram_kind = "se"

    def __init__(self, x=None, name=None, metric=ARD_L2, var=None):
        super().__init__(x, name, metric, var)


# ---------------------------------------------------------------------------
# periodic zoo: a per-dimension frequency and rate, one feature slab at a
# time instead of an N x M x d Difference tensor
# ---------------------------------------------------------------------------


class KernelPeriodic(KernelStationary):
    """Base periodic kernel with per-dim freq/rate hypers."""

    def __init__(self, x=None, name=None, metric=Difference, var=None, freq=None, rate=None):
        super().__init__(x, name, metric, var)
        self.freq = freq
        self.rate = rate

    def check_hypers(self, parent=""):
        super().check_hypers(parent=parent)
        self.freq = self._param(
            self.freq, parent + self.name + "_freq", FlatExp(), shape=self.shape)
        self.rate = self._param(
            self.rate, parent + self.name + "_rate", FlatExp(), shape=self.shape)

    def default_hypers(self, x=None, y=None):
        out = super().default_hypers(x, y)
        if is_param(self.freq):
            out[self.freq] = 1.0 / (x.max(axis=0) - x.min(axis=0))
        if is_param(self.rate):
            out[self.rate] = 1.0 / np.abs(np.diff(x, axis=0)).mean(axis=0)
        return out

    def _cols(self, x1, x2):
        return slice_dims(x1, self.metric.dims), slice_dims(x2, self.metric.dims)


class COS(KernelPeriodic):
    """prod_d cos(2 pi diff_d freq_d)."""

    def __init__(self, x=None, name=None, metric=Difference, var=None, freq=None):
        super().__init__(x, name, metric, var, freq, rate=1.0)

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        s1, s2 = self._cols(x1, x2)
        prod = pairwise_prod(s1, s2, lambda a, b, fd: torch.cos(2.0 * pi * (a - b) * fd),
                             hval(self.freq, params))
        return _scalar(self.var, params) * prod


class SIN(KernelPeriodic):
    """Exp-sin^2 periodic kernel: exp(-2 sum_d sin^2(pi diff_d freq_d)
    rate_d)."""

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        s1, s2 = self._cols(x1, x2)
        ssum = pairwise_sum(
            s1, s2, lambda a, b, fd, rd: torch.sin(pi * (a - b) * fd) ** 2 * rd,
            hval(self.freq, params), hval(self.rate, params))
        return _scalar(self.var, params) * torch.exp(-2.0 * ssum)


class SINC(KernelPeriodic):
    """prod_d sinc(2 pi^2 diff_d freq_d) with the 0/0 point patched to 1:
    the inner where keeps sin(0)/0 out of both the value and its
    gradient."""

    def __init__(self, x=None, name=None, metric=Difference, var=None, freq=None):
        super().__init__(x, name, metric, var, freq, rate=1.0)

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        s1, s2 = self._cols(x1, x2)

        def elem(a, b, fd):
            d = a - b
            arg = 2.0 * pi2 * d * fd
            safe = torch.where(d != 0.0, arg, torch.ones_like(arg))
            return torch.where(d != 0.0, torch.sin(safe) / safe, torch.ones_like(arg))

        return _scalar(self.var, params) * pairwise_prod(s1, s2, elem, hval(self.freq, params))


class SM(KernelPeriodic):
    """Spectral-mixture component: a gaussian envelope times a cosine."""

    def cov(self, params, x1, x2=None):
        if x2 is None:
            x2 = x1
        s1, s2 = self._cols(x1, x2)
        env = pairwise_sum(s1, s2, lambda a, b, rd: (a - b) ** 2 * rd ** 2,
                           hval(self.rate, params))
        cosp = pairwise_prod(s1, s2, lambda a, b, fd: torch.cos(2.0 * pi * (a - b) * fd),
                             hval(self.freq, params))
        return _scalar(self.var, params) * torch.exp(-2.0 * pi2 * env) * cosp


#: kind -> the k() the fused kernel bakes in; dispatch fires only when an
#: instance's k is exactly this (see _gram_dispatchable)
_GRAM_K_OWNERS = {
    "se": KernelStationaryExponential.k,
    "mat32": MAT32.k,
    "mat52": MAT52.k,
    "rq": RQ.k,
}
