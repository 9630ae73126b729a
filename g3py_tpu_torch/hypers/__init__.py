"""Hyperparameter-bearing function layer (the PyTorch counterpart of
:mod:`g3py_tpu.hypers`).

A hyperparameter is a :class:`Param` descriptor — name, shape and a
:class:`Prior` (an unconstrained <-> natural transform plus a log-prior
term).  Components collect Params into plain lists; the graphical-model
registry (:mod:`g3py_tpu_torch.bayesian.registry`) owns the dict <-> flat
array bijection and the prior logp.  Runtime values live in params dicts
keyed by ``Param.name``; :func:`hval` turns a slot into a tensor.

This slice carries the priors that exact GP/WGP regression registers:
:class:`Flat` (means, mapping shifts) and :class:`FlatExp` (amplitudes,
rates, noise, mapping scales and powers).

A params dict may carry a leading row axis on every value (the (R,) +
``Param.shape`` values of R hyperparameter rows, e.g. a sampler's walkers):
every component then returns a leading row axis too.  :func:`row_shape`
tells the rows of a value apart from the Param's own shape.
"""

import numpy as np
import torch

from ..config import settings, asarray_x, as_tensor

__all__ = [
    "Transform",
    "IdentityTransform",
    "LogTransform",
    "Prior",
    "Flat",
    "FlatExp",
    "Param",
    "Hypers",
    "hval",
    "is_param",
    "slice_dims",
    "row_shape",
]

GUARD = -1e30  # the reference's -1e30 NaN/Inf fallback


# ---------------------------------------------------------------------------
# transforms: unconstrained u  <->  natural v
# ---------------------------------------------------------------------------


class Transform:
    name = "id"

    def backward(self, u):  # unconstrained -> natural (tensor)
        return u

    def forward(self, v):  # natural -> unconstrained (host numpy)
        return v


class IdentityTransform(Transform):
    pass


class LogTransform(Transform):
    name = "log"

    def backward(self, u):
        return torch.exp(u)

    def forward(self, v):
        return np.log(np.maximum(np.asarray(v, dtype=np.float64), 1e-38)).astype(
            settings.floatx)


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------


class Prior:
    """Transform + log-prior contribution ``logp_natural(v)``, taken from
    the natural-space value flattened to (..., size): one term per leading
    row (the unconstrained-space ``logp`` comes with training)."""

    transform = IdentityTransform()

    def logp_natural(self, v):
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)

    def testval(self, shape):
        return np.zeros(shape, dtype=settings.floatx)


class Flat(Prior):
    """Unbounded flat prior."""


class FlatExp(Prior):
    """Flat in log space, with a hard wall where exp(u) <= 1e-6."""

    transform = LogTransform()

    def logp_natural(self, v):
        bad = (v <= 1e-6).any(dim=-1)
        # the wall in v's own dtype (a Python-scalar where() would round it
        # through float32), filled on the device (no host copy, no sync)
        wall = torch.full(bad.shape, GUARD, dtype=v.dtype, device=v.device)
        return torch.where(bad, wall, torch.zeros_like(wall))

    def testval(self, shape):
        return np.ones(shape, dtype=settings.floatx)


# ---------------------------------------------------------------------------
# Param
# ---------------------------------------------------------------------------


class Param:
    """A named hyperparameter slot: shape + prior.  Its value lives in a
    natural-space params dict under ``self.name``."""

    __slots__ = ("name", "shape", "prior")

    def __init__(self, name, shape=(), prior=None):
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape)
        self.prior = prior if prior is not None else Flat()

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    def testval(self):
        return self.prior.testval(self.shape)

    def __repr__(self):
        return f"Param({self.name}, shape={self.shape}, prior={type(self.prior).__name__})"


def is_param(h):
    return isinstance(h, Param)


def hval(h, params):
    """Resolve a hyper attribute to a tensor: Param -> its current value;
    anything else is a fixed constant."""
    if isinstance(h, Param):
        return as_tensor(params[h.name])
    return as_tensor(h)


def row_shape(h, value):
    """The leading row axes of ``value``, the tensor of Param ``h`` (``()``
    for a single params dict, ``(R,)`` for R rows)."""
    return value.shape[:value.ndim - len(h.shape)] if isinstance(h, Param) else ()


def slice_dims(x, dims):
    """Select a component's active input columns."""
    if x.ndim == 1:
        x = x[:, None]
    if dims is None:
        return x
    if isinstance(dims, slice):
        return x[:, dims]
    return x[:, torch.as_tensor(np.asarray(dims), device=x.device)]


# ---------------------------------------------------------------------------
# Hypers base
# ---------------------------------------------------------------------------


class Hypers:
    """Base of every hyperparameter-bearing component: dims/shape inference
    from the inputs, hyper registration, data-driven defaults, L1/L2
    regularization potentials."""

    def __init__(self, x=None, name=None):
        self.name = name if name is not None else type(self).__name__
        self.hypers = []
        self.shape = None
        self.dims = None
        self.potential = None
        if x is not None:
            self.check_dims(x)

    def check_dims(self, x=None):
        """Infer input width / active dims."""
        if self.shape is not None:
            return
        if x is not None:
            if isinstance(x, list):
                self.dims = np.array(x)
                self.shape = self.dims.shape
            elif isinstance(x, tuple):
                domain, self.dims = x
                self.shape = domain.shape[1] if len(domain.shape) > 1 else 1
            elif hasattr(x, "shape"):
                self.shape = x.shape[1] if len(x.shape) > 1 else 1
                self.dims = slice(0, self.shape)
            else:  # an integer width
                self.shape = int(x)
                self.dims = slice(0, self.shape)
        else:
            self.shape = None
            self.dims = slice(None)

    def _param(self, current, name, prior, shape=()):
        """Create-or-pass-through one hyper slot: None creates it with the
        component's default prior, a Prior creates it with that prior, a
        Param passes through, anything else is a fixed constant."""
        if isinstance(current, Prior):
            current = Param(name, shape=shape, prior=current)
        elif current is None:
            current = Param(name, shape=shape, prior=prior)
        if isinstance(current, Param):
            self.hypers.append(current)
        return current

    def check_hypers(self, parent=""):
        pass

    def default_hypers(self, x=None, y=None):
        return {}

    def default_hypers_dims(self, x=None, y=None):
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        if self.dims is not None and not (
            isinstance(self.dims, slice) and self.dims == slice(None)
        ):
            x = x[:, self.dims]
        return {k: asarray_x(v) for k, v in self.default_hypers(x, y).items()}

    def set_potential(self, hypers="", reg="L1", c=1):
        self.potential = (hypers, reg, c)

    def has_potential(self):
        return getattr(self, "potential", None) is not None

    def potential_logp(self, params):
        """L1/L2 regularization potential over matching hypers."""
        if getattr(self, "potential", None) is None:
            return None
        substr, reg, c = self.potential
        terms = []
        for p in self.hypers:
            if p.name.find(substr) > 0:
                v = hval(p, params)
                v = v.reshape(row_shape(p, v) + (-1,))  # one sum a row
                if reg == "L1":
                    terms.append(-v.abs().sum(dim=-1))
                elif reg == "L2":
                    terms.append(-(v ** 2).sum(dim=-1))
        if not terms:
            return None
        return c * sum(terms[1:], terms[0])

    def __str__(self):
        if len(self.hypers) == 0:
            return type(self).__name__
        return f"{type(self).__name__}[h={self.hypers}]"

    __repr__ = __str__
