"""Mean (location) functions with operator algebra (the PyTorch counterpart
of :mod:`g3py_tpu.hypers.means`): ``Zero``, ``Bias``, ``Linear``, ``Power``,
``BlackBox`` and ``+``/``*``, each ``(params, x) -> (N,)``, or ``(R, N)``
for a params dict of R rows (a mean with no Param, such as :class:`Zero`
or :class:`BlackBox`, stays ``(N,)`` and broadcasts)."""

import numpy as np
import torch

from . import Hypers, Flat, hval, is_param, slice_dims
from ..config import settings, as_tensor

__all__ = [
    "Mean",
    "Location",
    "BlackBox",
    "MeanOperation",
    "MeanComposition",
    "MeanScale",
    "MeanShift",
    "MeanProd",
    "MeanSum",
    "Zero",
    "Bias",
    "Linear",
    "Power",
]


def _per_point(h, params):
    """A scalar hyper shaped to broadcast over (N,) points: () or (R, 1)."""
    return hval(h, params)[..., None]


def _dot(x, coeff):
    """x @ coeff for a (d,) coeff, or (R, N) for a (R, d) one."""
    return torch.matmul(x, coeff[..., None])[..., 0]


class Mean(Hypers):
    """Base mean; ``__call__(params, x)`` slices the active dims, then
    evaluates."""

    def eval(self, params, x):
        raise NotImplementedError

    def __call__(self, params, x):
        return self.eval(params, slice_dims(x, self.dims))

    def __mul__(self, other):
        if isinstance(other, Mean):
            return MeanProd(self, other)
        return MeanScale(self, other)

    __imul__ = __mul__
    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, Mean):
            return MeanSum(self, other)
        return MeanShift(self, other)

    __iadd__ = __add__
    __radd__ = __add__


Location = Mean


class BlackBox(Mean):
    """A fixed array: its first N entries at N points."""

    def __init__(self, element, x=None, name=None):
        super().__init__(x, name)
        self.element = element

    def __call__(self, params, x):
        return as_tensor(self.element).to(x.device)[: x.shape[0]]

    eval = __call__


class MeanOperation(Mean):
    """mean (op) scalar element."""

    def __init__(self, _m, _element):
        self.m = _m
        self.element = _element
        self.hypers = []
        self.potential = None

    def check_hypers(self, parent=""):
        self.m.check_hypers(parent=parent)
        self.hypers = list(self.m.hypers)

    def check_dims(self, x=None):
        self.m.check_dims(x)

    def default_hypers_dims(self, x=None, y=None):
        return self.m.default_hypers_dims(x, y)

    def potential_logp(self, params):
        return self.m.potential_logp(params)


class MeanComposition(Mean):
    """mean (op) mean."""

    def __init__(self, _m1, _m2):
        self.m1 = _m1
        self.m2 = _m2
        self.hypers = []
        self.potential = None

    def check_hypers(self, parent=""):
        self.m1.check_hypers(parent=parent)
        self.m2.check_hypers(parent=parent)
        self.hypers = list(self.m1.hypers) + list(self.m2.hypers)

    def check_dims(self, x=None):
        self.m1.check_dims(x)
        self.m2.check_dims(x)

    def default_hypers_dims(self, x=None, y=None):
        return {
            **self.m1.default_hypers_dims(x, y),
            **self.m2.default_hypers_dims(x, y),
        }

    def potential_logp(self, params):
        parts = [p for p in (self.m1.potential_logp(params), self.m2.potential_logp(params))
                 if p is not None]
        return sum(parts[1:], parts[0]) if parts else None


class MeanScale(MeanOperation):
    def __call__(self, params, x):
        return _per_point(self.element, params) * self.m(params, x)


class MeanShift(MeanOperation):
    def __call__(self, params, x):
        return _per_point(self.element, params) + self.m(params, x)


class MeanProd(MeanComposition):
    def __call__(self, params, x):
        return self.m1(params, x) * self.m2(params, x)


class MeanSum(MeanComposition):
    def __call__(self, params, x):
        return self.m1(params, x) + self.m2(params, x)


class Zero(Mean):
    """m(x) = 0."""

    def eval(self, params, x):
        return torch.zeros((x.shape[0],), dtype=settings.dtype, device=x.device)


class Bias(Mean):
    """Constant mean, default = mean(y)."""

    def __init__(self, x=None, name=None, bias=None):
        super().__init__(x, name)
        self.bias = bias

    def check_hypers(self, parent=""):
        self.bias = self._param(self.bias, parent + self.name + "_Bias", Flat())

    def default_hypers(self, x=None, y=None):
        if not is_param(self.bias):
            return {}
        return {self.bias: np.asarray(np.mean(y), dtype=settings.floatx)}

    def eval(self, params, x):
        return _per_point(self.bias, params) * torch.ones(
            (x.shape[0],), dtype=settings.dtype, device=x.device)


class Linear(Mean):
    """constant + x @ coeff."""

    def __init__(self, x=None, name=None, constant=None, coeff=None):
        super().__init__(x, name)
        self.constant = constant
        self.coeff = coeff

    def check_hypers(self, parent=""):
        self.constant = self._param(self.constant, parent + self.name + "_Constant", Flat())
        self.coeff = self._param(self.coeff, parent + self.name + "_Coeff", Flat(),
                                 shape=self.shape)

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.constant):
            out[self.constant] = np.asarray(np.mean(y), dtype=settings.floatx)
        if is_param(self.coeff):
            out[self.coeff] = np.mean(y) / np.mean(x, axis=0)
        return out

    def eval(self, params, x):
        return _per_point(self.constant, params) + _dot(x, hval(self.coeff, params))


class Power(Mean):
    """constant + (x^n) @ coeff."""

    def __init__(self, x=None, name=None, constant=None, coeff=None, n=2):
        super().__init__(x, name)
        self.constant = constant
        self.coeff = coeff
        self.n = n

    def check_hypers(self, parent=""):
        self.constant = self._param(self.constant, parent + self.name + "_Constant", Flat())
        self.coeff = self._param(self.coeff, parent + self.name + "_Coeff", Flat(),
                                 shape=self.shape)

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.constant):
            out[self.constant] = np.asarray(np.mean(y), dtype=settings.floatx)
        if is_param(self.coeff):
            out[self.coeff] = np.mean(y) / np.mean(np.asarray(x) ** self.n, axis=0)
        return out

    def eval(self, params, x):
        return _per_point(self.constant, params) + _dot(x ** self.n, hval(self.coeff, params))
