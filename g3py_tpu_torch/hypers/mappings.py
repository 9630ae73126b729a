"""Scalar warpings (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.mappings`): each Mapping provides ``inv`` (observed
-> latent), ``__call__`` (latent -> observed) and
``logdet_dinv`` (the log-Jacobian of ``inv``).  This slice carries
:class:`Identity` (GP) and :class:`BoxCoxLinear` (the WGP workload's
warping); the Newton-inverse default forward comes with the warpings that
need it."""

import numpy as np
import torch

from . import Hypers, Flat, FlatExp, hval, is_param
from ..config import settings

__all__ = ["Mapping", "Identity", "BoxCoxLinear"]


def _n_of(y):
    return torch.tensor(y.shape[0], dtype=settings.dtype, device=y.device)


def _signed_power(v, p):
    return torch.sign(v) * torch.abs(v) ** p


class Mapping(Hypers):
    """Base warping: ``inv`` maps observed y to the latent gaussian domain,
    ``__call__`` maps back."""

    def inv(self, params, y):
        raise NotImplementedError

    def __call__(self, params, x):
        raise NotImplementedError(
            f"{type(self).__name__} has no analytic forward map in this port")

    def logdet_dinv(self, params, y):
        raise NotImplementedError


class Identity(Mapping):
    """T(x) = x."""

    def __init__(self, y=None, name=None):
        super().__init__(y, name)

    def __call__(self, params, x):
        return x

    def inv(self, params, y):
        return y

    def logdet_dinv(self, params, y):
        return torch.zeros((), dtype=settings.dtype, device=y.device)


class BoxCoxLinear(Mapping):
    """Box-Cox with input scale and output shift — the warping of the WGP
    benchmark workload."""

    def __init__(self, y=None, name=None, shift=None, scale=None, power=None):
        super().__init__(y, name)
        self.shift = shift
        self.scale = scale
        self.power = power

    def check_hypers(self, parent=""):
        self.shift = self._param(self.shift, parent + self.name + "_shift", Flat())
        self.scale = self._param(self.scale, parent + self.name + "_scale", FlatExp())
        self.power = self._param(self.power, parent + self.name + "_power", FlatExp())

    def default_hypers(self, x=None, y=None):
        out = {}
        for h in (self.shift, self.scale, self.power):
            if is_param(h):
                out[h] = np.asarray(1.0, settings.floatx)
        return out

    def __call__(self, params, x):
        p = hval(self.power, params)
        scaled = p * x + 1.0
        return (_signed_power(scaled, 1.0 / p) / hval(self.scale, params)
                - hval(self.shift, params))

    def inv(self, params, y):
        p = hval(self.power, params)
        shifted = hval(self.scale, params) * (y + hval(self.shift, params))
        # power -> 0 limit is the log map
        boxcox = (_signed_power(shifted, p) - 1.0) / torch.where(p < 1e-5, 1.0, p)
        return torch.where(p < 1e-5, torch.log(torch.abs(shifted) + 1e-32), boxcox)

    def logdet_dinv(self, params, y):
        p = hval(self.power, params)
        s = hval(self.scale, params)
        shifted = s * (y + hval(self.shift, params))
        return (p - 1.0) * torch.log(torch.abs(shifted)).sum() + _n_of(y) * torch.log(s)
