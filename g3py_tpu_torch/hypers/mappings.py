"""Scalar warpings (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.mappings`): each Mapping provides ``inv`` (observed
-> latent), ``__call__``/``forward`` (latent -> observed) and
``logdet_dinv`` (the log-Jacobian of ``inv``).  A warping without an
analytic forward (:class:`WarpingTanh`, :class:`WarpingBoxCox`,
:class:`MappingInvSum`) inverts ``inv`` numerically
(:func:`~g3py_tpu_torch.ops.root.newton_inverse`), and a warping without an
analytic Jacobian takes it from autograd (:meth:`Mapping.logdet_dinv_elem`).
``m1 @ m2`` composes two warpings (:class:`MappingComposed`).

With a params dict of R rows, ``inv`` and ``logdet_dinv`` of the observed
(N,) outputs give (R, N) and (R,); ``inv`` also takes (R, M) values, one
row per params row.  ``__call__`` takes latent values whose leading axis is
the row axis, of any trailing shape."""

import numpy as np
import torch

from . import Hypers, Flat, FlatExp, hval, is_param, row_shape
from ..config import settings
from ..ops.guards import to_num
from ..ops.root import newton_inverse

__all__ = [
    "Mapping",
    "MappingOperation",
    "MappingComposed",
    "MappingInvSum",
    "Identity",
    "LinearMapping",
    "LogShifted",
    "BoxCoxShifted",
    "BoxCoxLinear",
    "BoxCoxLinear2",
    "WarpingTanh",
    "WarpingBoxCox",
    "ArcsinhLinear",
    "SinhArcsinh",
    "Logistic",
]


def _signed_power(v, p):
    return torch.sign(v) * torch.abs(v) ** p


def _boxcox(shifted, p):
    """The signed Box-Cox transform of ``shifted`` at power ``p``, with the
    log map as its p -> 0 limit below 1e-5."""
    boxcox = (_signed_power(shifted, p) - 1.0) / torch.where(p < 1e-5, 1.0, p)
    return torch.where(p < 1e-5, torch.log(torch.abs(shifted) + 1e-32), boxcox)


def _over(v, x):
    """A per-row scalar ``v`` (``()`` or ``(R,)``) shaped to broadcast over
    ``x``, whose leading axis is the row axis when ``v`` has one."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


class Mapping(Hypers):
    """Base warping: ``inv`` maps observed y to the latent gaussian domain,
    ``__call__`` maps back."""

    def inv(self, params, y):
        raise NotImplementedError

    def _rows(self, params):
        """The row shape of ``params`` for this warping: ``(R,)`` for a
        dict of R rows, ``()`` for one."""
        for h in self.hypers:
            return row_shape(h, hval(h, params))
        return ()

    def __call__(self, params, x):
        """Default forward: numeric inversion of ``inv``, each row of a
        dict of rows stopping on its own, with implicit gradients."""
        rows = self._rows(params)
        flat = x.reshape(rows + (-1,))
        out = newton_inverse(lambda v: self.inv(params, v), flat, row_dims=len(rows),
                             dfunc=lambda v: self.inv_slope(params, v))
        return out.reshape(x.shape)

    def inv_slope(self, params, y):
        """Elementwise ``dT^{-1}/dy`` (autograd's; a warping with an
        analytic slope overrides it, which ``torch.export`` can trace)."""
        with torch.enable_grad():
            v = y.detach().requires_grad_(True)
            (slope,) = torch.autograd.grad(self.inv(params, v).sum(), v)
        return slope

    def forward(self, params, x):
        return self(params, x)

    def logdet_dinv(self, params, y):
        return self.logdet_dinv_num(params, y)

    def logdet_dinv_num(self, params, y):
        """log|det dT^{-1}/dy| of an elementwise warping: the sum of
        :meth:`logdet_dinv_elem`."""
        return self.logdet_dinv_elem(params, y).sum(dim=-1)

    def logdet_dinv_elem(self, params, y):
        """Per-element ``log dT^{-1}/dy_i`` by autograd (an elementwise
        map has a diagonal Jacobian: d(sum inv)/dy_i).  Differentiable in
        the params and in ``y`` when gradients are on."""
        rows = self._rows(params)
        v = y.expand(rows + y.shape[-1:]) if rows and y.ndim == 1 else y
        create = torch.is_grad_enabled() and (
            v.requires_grad or any(hval(h, params).requires_grad for h in self.hypers))
        if not v.requires_grad:
            v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            (slope,) = torch.autograd.grad(self.inv(params, v).sum(), v, create_graph=create)
        return torch.log(slope)

    def __matmul__(self, other):
        return MappingComposed(self, other)

    __imatmul__ = __matmul__
    __rmatmul__ = __matmul__


class MappingOperation(Mapping):
    """Two warpings combined; the hypers are both operands'."""

    def __init__(self, m1, m2):
        self.m1 = m1
        self.m2 = m2
        self.hypers = []
        self.potential = None
        self.op = "op"

    def check_hypers(self, parent=""):
        self.m1.check_hypers(parent=parent)
        self.m2.check_hypers(parent=parent)
        self.hypers = list(self.m1.hypers) + list(self.m2.hypers)

    def check_dims(self, x=None):
        self.m1.check_dims(x)
        self.m2.check_dims(x)

    def default_hypers_dims(self, x=None, y=None):
        return {**self.m1.default_hypers_dims(x, y), **self.m2.default_hypers_dims(x, y)}

    def has_potential(self):
        return self.m1.has_potential() or self.m2.has_potential()

    def potential_logp(self, params):
        parts = [p for p in (self.m1.potential_logp(params), self.m2.potential_logp(params))
                 if p is not None]
        return sum(parts[1:], parts[0]) if parts else None

    def __str__(self):
        return f"{self.m1} {self.op} {self.m2}"

    __repr__ = __str__


class MappingComposed(MappingOperation):
    """T = m1 after m2: ``inv`` is m2.inv after m1.inv, and the logdet the
    chain rule's."""

    def __init__(self, m1, m2):
        super().__init__(m1, m2)
        self.op = "@"
        self.name = self.m1.name + " " + self.m2.name

    def __call__(self, params, x):
        return self.m1(params, self.m2(params, x))

    def inv(self, params, y):
        return self.m2.inv(params, self.m1.inv(params, y))

    def logdet_dinv(self, params, y):
        return (self.m2.logdet_dinv(params, self.m1.inv(params, y))
                + self.m1.logdet_dinv(params, y))


class MappingInvSum(MappingOperation):
    """inv-only sum: T^{-1} = m1.inv + m2.inv; the forward is the Newton
    inverse and the Jacobian autograd's."""

    def __init__(self, m1, m2):
        super().__init__(m1, m2)
        self.op = "+^"

    def inv(self, params, y):
        return self.m1.inv(params, y) + self.m2.inv(params, y)

    def inv_slope(self, params, y):
        return self.m1.inv_slope(params, y) + self.m2.inv_slope(params, y)


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


class LinearMapping(Mapping):
    """T(x) = scale (x - shift)."""

    def __init__(self, y=None, name=None, shift=None, scale=None):
        super().__init__(y, name)
        self.shift = shift
        self.scale = scale

    def check_hypers(self, parent=""):
        self.shift = self._param(self.shift, parent + self.name + "_shift", Flat())
        self.scale = self._param(self.scale, parent + self.name + "_scale", FlatExp())

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.shift):
            out[self.shift] = np.asarray(0.0, settings.floatx)
        if is_param(self.scale):
            out[self.scale] = np.asarray(1.0, settings.floatx)
        return out

    def __call__(self, params, x):
        return _over(hval(self.scale, params), x) * (x - _over(hval(self.shift, params), x))

    def inv(self, params, y):
        return y / hval(self.scale, params)[..., None] + hval(self.shift, params)[..., None]

    def logdet_dinv(self, params, y):
        return -y.shape[-1] * torch.log(hval(self.scale, params))


class LogShifted(Mapping):
    """T(x) = exp(x) + shift."""

    def __init__(self, y=None, name=None, shift=None):
        super().__init__(y, name)
        self.shift = shift

    def check_hypers(self, parent=""):
        self.shift = self._param(self.shift, parent + self.name + "_shift", Flat())

    def default_hypers(self, x=None, y=None):
        if not is_param(self.shift):
            return {}
        return {self.shift: np.asarray(np.min(y) - 1.0, settings.floatx)}

    def __call__(self, params, x):
        return torch.exp(x) + _over(hval(self.shift, params), x)

    def inv(self, params, y):
        return torch.log(torch.clamp(y - hval(self.shift, params)[..., None], min=1e-32))

    def logdet_dinv(self, params, y):
        return -torch.log(y - hval(self.shift, params)[..., None]).sum(dim=-1)


class BoxCoxShifted(Mapping):
    """Signed Box-Cox with an output shift."""

    def __init__(self, y=None, name="BoxShift", shift=None, power=None):
        super().__init__(y, name)
        self.shift = shift
        self.power = power

    def check_hypers(self, parent=""):
        self.shift = self._param(self.shift, parent + self.name + "_shift", Flat())
        self.power = self._param(self.power, parent + self.name + "_power", FlatExp())

    def default_hypers(self, x=None, y=None):
        out = {}
        for h in (self.shift, self.power):
            if is_param(h):
                out[h] = np.asarray(1.0, settings.floatx)
        return out

    def __call__(self, params, x):
        p = _over(hval(self.power, params), x)
        return _signed_power(p * x + 1.0, 1.0 / p) - _over(hval(self.shift, params), x)

    def inv(self, params, y):
        shifted = y + hval(self.shift, params)[..., None]
        return _boxcox(shifted, hval(self.power, params)[..., None])

    def logdet_dinv(self, params, y):
        p = hval(self.power, params)
        shifted = y + hval(self.shift, params)[..., None]
        return (p - 1.0) * torch.log(torch.abs(shifted)).sum(dim=-1)


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
        shifted = hval(self.scale, params)[..., None] * (y + hval(self.shift, params)[..., None])
        return _boxcox(shifted, hval(self.power, params)[..., None])

    def logdet_dinv(self, params, y):
        p = hval(self.power, params)
        s = hval(self.scale, params)
        shifted = s[..., None] * (y + hval(self.shift, params)[..., None])
        return ((p - 1.0) * torch.log(torch.abs(shifted)).sum(dim=-1)
                + y.shape[-1] * torch.log(s))


class BoxCoxLinear2(Mapping):
    """Box-Cox of scale * y + shift, with the output scaled back."""

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
        return ((_signed_power(p * x + 1.0, 1.0 / p) - _over(hval(self.shift, params), x))
                / _over(hval(self.scale, params), x))

    def inv(self, params, y):
        shifted = hval(self.scale, params)[..., None] * y + hval(self.shift, params)[..., None]
        return _boxcox(shifted, hval(self.power, params)[..., None])

    def logdet_dinv(self, params, y):
        p = hval(self.power, params)
        s = hval(self.scale, params)
        shifted = s[..., None] * y + hval(self.shift, params)[..., None]
        coeff = torch.where(p < 1e-5, -1.0, p - 1.0)
        return coeff * torch.log(torch.abs(shifted)).sum(dim=-1) + y.shape[-1] * torch.log(s)


class WarpingTanh(Mapping):
    """Sum-of-tanh warping T^{-1}(y) = y + sum_k a_k tanh(b_k (y + c_k)),
    with vectors a, b, c of length ``n``; inv-only, so its forward is the
    Newton inverse and its Jacobian autograd's."""

    def __init__(self, y=None, n=1, name=None, a=None, b=None, c=None):
        super().__init__(y, name)
        self.n = n
        self.a = a
        self.b = b
        self.c = c

    def check_hypers(self, parent=""):
        self.a = self._param(self.a, parent + self.name + "_a", FlatExp(), shape=self.n)
        self.b = self._param(self.b, parent + self.name + "_b", FlatExp(), shape=self.n)
        self.c = self._param(self.c, parent + self.name + "_c", Flat(), shape=self.n)

    def default_hypers(self, x=None, y=None):
        out = {}
        ymax = np.abs(y).max()
        if is_param(self.a):
            out[self.a] = 0.1 * np.ones(self.n, settings.floatx) * ymax / self.n
        if is_param(self.b):
            out[self.b] = 0.1 * np.ones(self.n, settings.floatx) / ymax
        if is_param(self.c):
            out[self.c] = np.ones(self.n, settings.floatx) * np.mean(y)
        return out

    def inv(self, params, y):
        a, b, c = (hval(h, params)[..., None, :] for h in (self.a, self.b, self.c))
        return y + (torch.tanh(b * (y[..., None] + c)) * a).sum(dim=-1)

    def inv_slope(self, params, y):
        a, b, c = (hval(h, params)[..., None, :] for h in (self.a, self.b, self.c))
        t = torch.tanh(b * (y[..., None] + c))
        return 1.0 + (a * (1.0 - t * t) * b).sum(dim=-1)


class WarpingBoxCox(Mapping):
    """Mixture-of-Box-Cox warping T^{-1}(y) = sum_k w_k ((y + shift_k)^power_k
    - 1) / power_k (signed powers), vectors of length ``n``; inv-only, so
    its forward is the Newton inverse and its Jacobian autograd's."""

    def __init__(self, y=None, n=1, name=None, shift=None, power=None, w=None):
        super().__init__(y, name)
        self.n = n
        self.shift = shift
        self.power = power
        self.w = w

    def check_hypers(self, parent=""):
        self.shift = self._param(self.shift, parent + self.name + "_shift", FlatExp(),
                                 shape=self.n)
        self.power = self._param(self.power, parent + self.name + "_power", FlatExp(),
                                 shape=self.n)
        self.w = self._param(self.w, parent + self.name + "_w", FlatExp(), shape=self.n)

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.w):
            out[self.w] = np.ones(self.n, settings.floatx) / self.n
        if is_param(self.shift):
            out[self.shift] = np.ones(self.n, settings.floatx)
        if is_param(self.power):
            out[self.power] = np.ones(self.n, settings.floatx)
        return out

    def inv(self, params, y):
        shift, power, w = (hval(h, params)[..., None, :] for h in (self.shift, self.power, self.w))
        z = y[..., None] + shift
        return ((_signed_power(z, power) - 1.0) / power * w).sum(dim=-1)

    def inv_slope(self, params, y):
        shift, power, w = (hval(h, params)[..., None, :] for h in (self.shift, self.power, self.w))
        return (torch.abs(y[..., None] + shift) ** (power - 1.0) * w).sum(dim=-1)


class ArcsinhLinear(Mapping):
    """T(x) = sinh((x - shift) / scale)."""

    def __init__(self, y=None, name=None, shift=None, scale=None):
        super().__init__(y, name)
        self.shift = shift
        self.scale = scale

    def check_hypers(self, parent=""):
        self.shift = self._param(self.shift, parent + self.name + "_shift", Flat())
        self.scale = self._param(self.scale, parent + self.name + "_scale", FlatExp())

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.shift):
            out[self.shift] = np.asarray(np.mean(y), settings.floatx)
        if is_param(self.scale):
            out[self.scale] = np.asarray(np.std(y), settings.floatx)
        return out

    def __call__(self, params, x):
        return torch.sinh((x - _over(hval(self.shift, params), x))
                          / _over(hval(self.scale, params), x))

    def inv(self, params, y):
        return (torch.arcsinh(y) * hval(self.scale, params)[..., None]
                + hval(self.shift, params)[..., None])

    def logdet_dinv(self, params, y):
        return (y.shape[-1] * torch.log(hval(self.scale, params))
                - 0.5 * torch.log1p(y ** 2).sum(dim=-1))


class SinhArcsinh(Mapping):
    """Sinh-arcsinh warping (Jones & Pewsey): T(x) = sinh((arcsinh(x) -
    shift) / scale)."""

    def __init__(self, y=None, name=None, shift=None, scale=None):
        super().__init__(y, name)
        self.shift = shift
        self.scale = scale

    def check_hypers(self, parent=""):
        self.shift = self._param(self.shift, parent + self.name + "_shift", Flat())
        self.scale = self._param(self.scale, parent + self.name + "_scale", FlatExp())

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.shift):
            out[self.shift] = np.asarray(0.0, settings.floatx)
        if is_param(self.scale):
            out[self.scale] = np.asarray(1.0, settings.floatx)
        return out

    def __call__(self, params, x):
        return torch.sinh((torch.arcsinh(x) - _over(hval(self.shift, params), x))
                          / _over(hval(self.scale, params), x))

    def inv(self, params, y):
        return torch.sinh(hval(self.shift, params)[..., None]
                          + hval(self.scale, params)[..., None] * torch.arcsinh(y))

    def logdet_dinv(self, params, y):
        shift = hval(self.shift, params)
        scale = hval(self.scale, params)
        return (torch.log(torch.cosh(shift[..., None] + scale[..., None]
                                     * torch.arcsinh(y))).sum(dim=-1)
                + y.shape[-1] * torch.log(scale) - 0.5 * torch.log1p(y ** 2).sum(dim=-1))


class Logistic(Mapping):
    """Bounded logistic warping onto (lower, lower + high)."""

    def __init__(self, y=None, name=None, lower=None, high=None, location=None, scale=None):
        super().__init__(y, name)
        self.lower = lower
        self.high = high
        self.location = location
        self.scale = scale

    def check_hypers(self, parent=""):
        self.lower = self._param(self.lower, parent + self.name + "_lower", Flat())
        self.high = self._param(self.high, parent + self.name + "_high", FlatExp())
        self.location = self._param(self.location, parent + self.name + "_location", Flat())
        self.scale = self._param(self.scale, parent + self.name + "_scale", FlatExp())

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.lower):
            out[self.lower] = 1.5 * np.min(y) - 0.5 * np.max(y)
        if is_param(self.high):
            out[self.high] = 2.0 * (np.max(y) - np.min(y))
        if is_param(self.location):
            out[self.location] = np.mean(y)
        if is_param(self.scale):
            out[self.scale] = np.std(y)
        return out

    def __call__(self, params, x):
        lower, high, loc, scale = (_over(hval(h, params), x) for h in
                                   (self.lower, self.high, self.location, self.scale))
        return lower + high * (0.5 + 0.5 * torch.tanh((x - loc) / (2 * scale)))

    def _p(self, params, y):
        """(y - lower) / high, clipped to [0, 1] by two wheres."""
        lower = hval(self.lower, params)[..., None]
        high = hval(self.high, params)[..., None]
        inner = torch.where(y > lower + high, 1.0, (y - lower) / high)
        return torch.where(y < lower, 0.0, inner)

    def inv(self, params, y):
        p = self._p(params, y)
        return (hval(self.location, params)[..., None]
                + hval(self.scale, params)[..., None] * to_num(torch.log(p / (1.0 - p))))

    def logdet_dinv(self, params, y):
        p = self._p(params, y)
        high = hval(self.high, params)[..., None]
        scale = hval(self.scale, params)[..., None]
        return to_num(torch.log(scale / (high * p * (1.0 - p)))).sum(dim=-1)
