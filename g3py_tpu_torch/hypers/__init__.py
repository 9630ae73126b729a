"""Hyperparameter-bearing function layer (the PyTorch counterpart of
:mod:`g3py_tpu.hypers`).

A hyperparameter is a :class:`Param` descriptor — name, shape and a
:class:`Prior` (an unconstrained <-> natural transform plus a log-prior
term).  Components collect Params into plain lists; the graphical-model
registry (:mod:`g3py_tpu_torch.bayesian.registry`) owns the dict <-> flat
array bijection and the prior logp.  Runtime values live in params dicts
keyed by ``Param.name``; :func:`hval` turns a slot into a tensor.

The priors map one-to-one onto the JAX package's: :class:`Flat` and
:class:`Null` (unbounded, flat), :class:`ExpFlat` (flat on the value,
sampled in log space), :class:`FlatExp` (flat in log space, a wall below
1e-6), :class:`FlatPos` (flat on (0, inf), natural-space sampling),
:class:`FlatExpId` (the log-below-1, identity-above transform),
:class:`Exponential` and :class:`Uniform`.  Each gives its term as a
function of the natural value (``logp_natural``) and of the unconstrained
value (``logp``); the two agree.  :class:`Freedom` is the Student-t
families' degrees-of-freedom hyper.

A params dict may carry a leading row axis on every value (the (R,) +
``Param.shape`` values of R hyperparameter rows, e.g. a sampler's walkers):
every component then returns a leading row axis too.  :func:`row_shape`
tells the rows of a value apart from the Param's own shape.
"""

import numpy as np
import torch

from ..config import settings, asarray_x, as_tensor
from ..utils import DictObj

__all__ = [
    "Transform",
    "IdentityTransform",
    "LogTransform",
    "LogIdTransform",
    "IntervalTransform",
    "Prior",
    "Flat",
    "Null",
    "ExpFlat",
    "FlatExp",
    "FlatPos",
    "PositiveFlat",
    "NonTransformLog",
    "FlatExpId",
    "Exponential",
    "Uniform",
    "Param",
    "Hypers",
    "Freedom",
    "hval",
    "is_param",
    "slice_dims",
    "row_shape",
    "zeros",
    "ones",
    "cvalues",
    "get_hypers_floatX",
]

GUARD = -1e30  # the reference's -1e30 NaN/Inf fallback


def zeros(shape):
    return np.zeros(shape, dtype=settings.floatx)


def ones(shape):
    return np.ones(shape, dtype=settings.floatx)


def cvalues(shape, val):
    return (np.ones(shape, dtype=settings.floatx) * val).astype(settings.floatx)


def get_hypers_floatX(params):
    """A params dict with every value a host array in ``settings.floatx``."""
    return DictObj({k: asarray_x(v) for k, v in params.items()})


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


def _host64(v):
    return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                      dtype=np.float64)


class LogTransform(Transform):
    name = "log"

    def backward(self, u):
        return torch.exp(u)

    def forward(self, v):
        return np.log(np.maximum(_host64(v), 1e-38)).astype(settings.floatx)


class LogIdTransform(Transform):
    """log below 1, identity-1 above."""

    name = "logid"

    def backward(self, u):
        return torch.where(u < 0, torch.exp(torch.clamp(u, max=0.0)), u + 1.0)

    def forward(self, v):
        v = _host64(v)
        return np.where(v < 1, np.log(np.maximum(v, 1e-38)), v - 1.0).astype(settings.floatx)


class IntervalTransform(Transform):
    """(lower, upper) through the logit."""

    name = "interval"

    def __init__(self, lower, upper):
        self.lower = float(lower)
        self.upper = float(upper)

    def backward(self, u):
        return self.lower + (self.upper - self.lower) * torch.sigmoid(u)

    def forward(self, v):
        p = np.clip((_host64(v) - self.lower) / (self.upper - self.lower), 1e-12, 1 - 1e-12)
        return np.log(p / (1 - p)).astype(settings.floatx)


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------


class Prior:
    """Transform + log-prior contribution, taken from the value flattened to
    (..., size): one term per leading row.  ``logp_natural(v)`` reads the
    natural-space value, ``logp(u)`` the unconstrained one (density plus
    the transform's Jacobian); ``logp(u) == logp_natural(backward(u))``."""

    transform = IdentityTransform()

    def logp(self, u):
        return self.logp_natural(self.transform.backward(u))

    def logp_natural(self, v):
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)

    def testval(self, shape):
        return np.zeros(shape, dtype=settings.floatx)


def _wall(bad, like):
    """``GUARD`` where ``bad``, else 0, in ``like``'s dtype (a Python-scalar
    where() would round the wall through float32), filled on the device (no
    host copy, no sync)."""
    wall = torch.full(bad.shape, GUARD, dtype=like.dtype, device=like.device)
    return torch.where(bad, wall, torch.zeros_like(wall))


class Flat(Prior):
    """Unbounded flat prior."""


class Null(Flat):
    """No-density placeholder."""


class ExpFlat(Prior):
    """Flat on the value, sampled in log space (Jacobian ``+u``)."""

    transform = LogTransform()

    def logp(self, u):
        return u.sum(dim=-1)

    def logp_natural(self, v):
        return torch.log(v).sum(dim=-1)

    def testval(self, shape):
        return np.ones(shape, dtype=settings.floatx)


class FlatExp(Prior):
    """Flat in log space, with a hard wall where exp(u) <= 1e-6."""

    transform = LogTransform()
    _wall = float(np.log(1e-6))

    def logp(self, u):
        return _wall((u <= self._wall).any(dim=-1), u)

    def logp_natural(self, v):
        return _wall((v <= 1e-6).any(dim=-1), v)

    def testval(self, shape):
        return np.ones(shape, dtype=settings.floatx)


class FlatPos(Prior):
    """Flat on (0, inf), sampled in natural space."""

    def logp_natural(self, v):
        return _wall(~(v > 0).all(dim=-1), v)

    logp = logp_natural

    def testval(self, shape):
        return np.ones(shape, dtype=settings.floatx)


class FlatExpId(Prior):
    """Flat under the LogId transform; the Jacobian term is
    ``sum(min(u, 0))``."""

    transform = LogIdTransform()

    def logp(self, u):
        return torch.clamp(u, max=0.0).sum(dim=-1)

    def logp_natural(self, v):
        return torch.where(v < 1.0, torch.log(torch.clamp(v, min=1e-38)),
                           torch.zeros_like(v)).sum(dim=-1)

    def testval(self, shape):
        return np.ones(shape, dtype=settings.floatx)


class Exponential(Prior):
    """Exponential(lam), sampled in log space: sum(log lam - lam v + u)."""

    transform = LogTransform()

    def __init__(self, lam=1.0):
        self.lam = float(lam)

    def logp(self, u):
        return (np.log(self.lam) - self.lam * torch.exp(u) + u).sum(dim=-1)

    def logp_natural(self, v):
        return (np.log(self.lam) - self.lam * v + torch.log(v)).sum(dim=-1)

    def testval(self, shape):
        return np.ones(shape, dtype=settings.floatx)


class Uniform(Prior):
    """Uniform(lower, upper), sampled in logit space: -log(U-L) + the
    log-Jacobian; GUARD outside (lower, upper)."""

    def __init__(self, lower=0.0, upper=1.0):
        self.lower = float(lower)
        self.upper = float(upper)
        self.transform = IntervalTransform(lower, upper)

    def logp(self, u):
        width = np.log(self.upper - self.lower)
        zero = torch.zeros_like(u)
        jac = width - torch.logaddexp(zero, -u) - torch.logaddexp(zero, u)
        return (-width + jac).sum(dim=-1)

    def logp_natural(self, v):
        width = self.upper - self.lower
        p = (v - self.lower) / width
        inside = ((p > 0) & (p < 1)).all(dim=-1)
        jac = (torch.log(torch.clamp(p, 1e-38, 1.0)) + torch.log(torch.clamp(1 - p, 1e-38, 1.0))
               + np.log(width)).sum(dim=-1)
        value = -v.shape[-1] * np.log(width) + jac
        return torch.where(inside, value, torch.full_like(value, GUARD))

    def testval(self, shape):
        return np.full(shape, 0.5 * (self.lower + self.upper), dtype=settings.floatx)


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
    """Select a component's active input columns (the last axis: inputs
    with a leading row axis, such as a stack of inducing sets, keep it)."""
    if x.ndim == 1:
        x = x[:, None]
    if dims is None:
        return x
    if isinstance(dims, slice):
        return x[..., dims]
    return x[..., torch.as_tensor(np.asarray(dims), device=x.device)]


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


class Freedom(Hypers):
    """Degrees-of-freedom hyper of the Student-t families: value = bound +
    degree, default degree = the number of observations."""

    def __init__(self, x=None, name=None, degree=None, bound=2.0):
        super().__init__(x, name)
        self.degree = degree
        self.bound = float(bound)

    def check_hypers(self, parent=""):
        self.degree = self._param(self.degree, parent + self.name + "_degree", FlatExp())

    def default_hypers(self, x=None, y=None):
        if is_param(self.degree):
            return {self.degree: np.asarray(len(y), dtype=settings.floatx)}
        return {}

    def __call__(self, params, x=None):
        return self.bound + hval(self.degree, params)


# the reference's names for two of the classes above
PositiveFlat = FlatPos
NonTransformLog = LogTransform
