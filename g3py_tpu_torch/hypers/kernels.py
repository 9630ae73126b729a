"""Covariance kernels (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.kernels`): the same class hierarchy, ``+`` algebra
and data-driven defaults, every ``cov`` a function of a params dict.

:meth:`KernelStationary.cov` sends SE, MAT32, MAT52 and RQ on an ARD_L2
metric through :func:`g3py_tpu_torch.ops.stationary_gram.stationary_gram`,
which launches the hand-written CUDA kernel for CUDA tensors (and computes
its plain version for CPU tensors).  A subclass that overrides ``k`` takes
the generic path: the kernel bakes in the family's own ``k``.  A params
dict of R rows gives (R, m, n) grams; the rows' fused grams share one
launch.
"""

import numpy as np
import torch

from . import Hypers, FlatExp, hval, is_param
from ..config import settings
from ..ops.stationary_gram import stationary_gram
from .metrics import Delta, ARD_L2

__all__ = [
    "Kernel",
    "KernelComposition",
    "KernelSum",
    "KernelStationary",
    "KernelNoise",
    "KernelStationaryExponential",
    "SE",
    "MAT32",
    "MAT52",
    "RQ",
]


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

    def cov(self, params, x1, x2=None):
        raise NotImplementedError

    def __add__(self, other):
        if isinstance(other, Kernel):
            return KernelSum(self, other)
        return NotImplemented

    def __str__(self):
        return f"{type(self).__name__}[m={self.metric},h={self.hypers}]"

    __repr__ = __str__


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
        family's own k(): a subclass overriding k gets the generic path."""
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
        return (hval(self.var, params)[..., None, None]
                * self.k(params, self.metric.gram(params, x1, x2)))


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

    def has_potential(self):
        return (getattr(self, "potential", None) is not None
                or self.k1.has_potential() or self.k2.has_potential())

    @property
    def name(self):
        return f"{self.k1.name} {self.op} {self.k2.name}"

    def __str__(self):
        return f"{self.k1} {self.op} {self.k2}"

    __repr__ = __str__


class KernelSum(KernelComposition):
    def __init__(self, _k1, _k2):
        super().__init__(_k1, _k2)
        self.op = "+"

    def cov(self, params, x1, x2=None):
        return self.k1.cov(params, x1, x2) + self.k2.cov(params, x1, x2)


class KernelNoise(KernelStationary):
    """Observation noise: var * I on a square cov, exactly 0 on cross-covs
    (the prior/posterior noise split hinges on this asymmetry)."""

    def __init__(self, x=None, name=None, metric=Delta, var=None):
        super().__init__(x, name, metric, var)

    def cov(self, params, x1, x2=None):
        if x2 is None:
            return hval(self.var, params)[..., None, None] * torch.eye(
                x1.shape[0], dtype=settings.dtype, device=x1.device)
        return torch.zeros((x1.shape[0], x2.shape[0]), dtype=settings.dtype,
                           device=x1.device)


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
        a = hval(self.alpha, params)[..., None, None]
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


class SE(KernelStationaryExponential):
    """Squared exponential: exp(-ARD_L2)."""

    _gram_kind = "se"

    def __init__(self, x=None, name=None, metric=ARD_L2, var=None):
        super().__init__(x, name, metric, var)


#: kind -> the k() the fused kernel bakes in; dispatch fires only when an
#: instance's k is exactly this (see _gram_dispatchable)
_GRAM_K_OWNERS = {
    "se": KernelStationaryExponential.k,
    "mat32": MAT32.k,
    "mat52": MAT52.k,
    "rq": RQ.k,
}
