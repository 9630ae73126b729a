"""The reference's names, mapped onto the port (its own copy of
:mod:`g3py_tpu.compat`).

The reference flattens everything into its top-level namespace, so users
reach for names like ``tt_to_num`` or ``makefn``.  Each name here maps onto
the port's equivalent in torch; ``debug_p`` needs machinery that is not ported
yet and raises with the ROADMAP item that brings it.
"""

import torch

from .bayesian.registry import GraphicalModel
from .ops.guards import to_num, inf_to_num, to_cov, to_bounded
from .ops.linalg import safe_cholesky
from .ops.root import newton_inverse
from .utils.reference_io import natural_to_transformed

__all__ = [
    "tt_to_num",
    "inf_to_num",
    "tt_to_cov",
    "tt_to_bounded",
    "cholesky_robust",
    "CholeskyRobust",
    "inverse_function",
    "gradient",
    "gradient1",
    "makefn",
    "transformed_hypers",
    "modelcontext",
    "debug_p",
]

# the reference's guards, with the same call shapes
tt_to_num = to_num
tt_to_cov = to_cov
tt_to_bounded = to_bounded

# the reference's CholeskyRobust: jitter-escalating factorization with
# Murray's gradient (K2 on the card); call it on an (n, n) PSD tensor
cholesky_robust = safe_cholesky
CholeskyRobust = safe_cholesky

# the reference's inverse_function: here the bracketed bisection-Newton
# inverse with implicit gradients
inverse_function = newton_inverse


def gradient(fn, argnums=0):
    """The reference's ``gradient(cost, wrt)``: the gradient of a scalar
    function of tensors (``torch.func.grad``)."""
    return torch.func.grad(fn, argnums=argnums)


def gradient1(fn, argnums=0):
    """The reference's ``gradient1(f, v)``: the flattened gradient of a
    scalar function with respect to one input."""
    g = torch.func.grad(fn, argnums=argnums)

    def flat(*args, **kwargs):
        return g(*args, **kwargs).reshape(-1)

    return flat


class _CountedFn:
    """A callable that counts its calls (``executed``), as the reference's
    compiled functions did; PyTorch runs it eagerly."""

    def __init__(self, fn, name):
        self.fn = fn
        self.name = name
        self.executed = 0

    def __call__(self, *args, **kwargs):
        self.executed += 1
        return self.fn(*args, **kwargs)


def makefn(fn, name="makefn"):
    """The reference's ``makefn`` compiled a graph into a counted callable;
    here the function runs eagerly behind a call counter."""
    return _CountedFn(fn, name)


def transformed_hypers(hypers):
    """Natural-space params -> the transformed (sampling) names, e.g.
    ``{'GP_SE_var': v} -> {'GP_SE_var_log_': log v}``."""
    return natural_to_transformed(hypers)


def modelcontext(model=None):
    """The enclosing model: ``model`` itself when given, else the active
    registry (``GraphicalModel.active``, None when there is none)."""
    if model is not None:
        return model
    return GraphicalModel.active


def debug_p(msg):
    """The reference's tracing print: prints ``msg`` when the debug switch
    of :mod:`g3py_tpu_torch.utils.debug` is on (``set_debug(True)``)."""
    from .utils import debug as _dbg

    if _dbg._DEBUG:
        print(msg)
