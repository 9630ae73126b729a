"""Scalar warpings (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.mappings`): each Mapping provides ``inv`` (observed
-> latent), ``__call__`` (latent -> observed) and
``logdet_dinv`` (the log-Jacobian of ``inv``).  This slice carries
:class:`Identity` (GP) and :class:`BoxCoxLinear` (the WGP workload's
warping); the Newton-inverse default forward comes with the warpings that
need it.

With a params dict of R rows, ``inv`` and ``logdet_dinv`` of the observed
(N,) outputs give (R, N) and (R,), and ``__call__`` takes latent values
whose leading axis is the row axis, of any trailing shape."""

import numpy as np
import torch

from . import Hypers, Flat, FlatExp, hval, is_param
from ..config import settings

__all__ = ["Mapping", "Identity", "BoxCoxLinear"]


def _signed_power(v, p):
    return torch.sign(v) * torch.abs(v) ** p


def _over(v, x):
    """A per-row scalar ``v`` (``()`` or ``(R,)``) shaped to broadcast over
    ``x``, whose leading axis is the row axis when ``v`` has one."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


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
        p = _over(hval(self.power, params), x)
        scaled = p * x + 1.0
        return (_signed_power(scaled, 1.0 / p) / _over(hval(self.scale, params), x)
                - _over(hval(self.shift, params), x))

    def inv(self, params, y):
        p = hval(self.power, params)[..., None]
        shifted = hval(self.scale, params)[..., None] * (y + hval(self.shift, params)[..., None])
        # power -> 0 limit is the log map
        boxcox = (_signed_power(shifted, p) - 1.0) / torch.where(p < 1e-5, 1.0, p)
        return torch.where(p < 1e-5, torch.log(torch.abs(shifted) + 1e-32), boxcox)

    def logdet_dinv(self, params, y):
        p = hval(self.power, params)
        s = hval(self.scale, params)
        shifted = s[..., None] * (y + hval(self.shift, params)[..., None])
        return ((p - 1.0) * torch.log(torch.abs(shifted)).sum(dim=-1)
                + y.shape[0] * torch.log(s))
