"""Numeric inversion of a monotone elementwise map, with implicit gradients
(the PyTorch counterpart of :mod:`g3py_tpu.ops.root`).

The forward solve is the JAX package's: a doubling bracket expansion (a NaN
from outside a warping's domain reads as the matching infinity), then
Newton steps with bisection whenever a step leaves the bracket.  Bisection
alone is float32-exact in <= 60 halvings, so a stiff warping (a trained
``WarpingTanh`` with b ~ e^15, a near-step in float32) still converges.

JAX runs both loops as ``lax.while_loop`` on the device.  Here the loops run
on the host and every step stays on the device: the loop condition is a
device flag, a step whose condition fails leaves the state as it was, and
the host reads the flags once every ``CHECK_EVERY`` steps.  The iterates are
those of the JAX loop (the steps past its exit change nothing), at one host
sync per ``CHECK_EVERY`` steps instead of one per step.  Under
``torch.export``, which cannot trace a host read, both loops are
``while_loop`` operators with their conditions on the device, as in the JAX
package: a step leaves converged rows frozen, so the values are those of
the host loop.  Eagerly the host loop stays: an eager ``while_loop`` goes
through ``torch.compile``, which refuses some warpings' steps (the
MappingInvSum's, as aliasing).  ``dfunc``, the slope of ``func``, replaces
autograd's (which ``torch.export`` cannot trace either).

Gradient: the root is found without a graph, then one differentiable
correction ``x* - (g(x*) - sg(g(x*))) / sg(g'(x*))`` (``sg`` = detach) is
added: its value is x*, its gradient the implicit function theorem's,
dx/dz = 1/f'(x) and dx/dtheta = -(df/dtheta)/f'(x) for every parameter that
``func`` closes over — what ``lax.custom_root`` gives the JAX package.
"""

import torch

__all__ = ["newton_inverse"]

#: steps between two host reads of the loop flags
CHECK_EVERY = 8


def _value_and_slope(g, x, dg=None):
    """``(g(x), g'(x))`` of an elementwise ``g``, both detached; the slope
    is ``dg(x)`` when given, else autograd's."""
    if dg is not None:
        with torch.no_grad():
            return g(x), dg(x)
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        gx = g(xg)
        (slope,) = torch.autograd.grad(gx.sum(), xg)
    return gx.detach(), slope


def _loop(step, state, count, traced):
    """Run ``state = step(*state)`` up to ``count`` times while its last
    entry (the per-row ``active`` flags) has a True: on the host with one
    read of the flags every ``CHECK_EVERY`` steps, or with ``traced`` as a
    ``while_loop`` operator whose condition stays on the device (a graph
    that ``torch.export`` records).  A step leaves converged rows as they
    are, so both give the same values."""
    if traced:
        from torch._higher_order_ops import while_loop

        i0 = torch.zeros((), dtype=torch.int64, device=state[0].device)
        out = while_loop(lambda i, *st: (i < count) & st[-1].any(),
                         lambda i, *st: (i + 1, *step(*st)), (i0, *state))
        return out[1:]
    for i in range(count):
        state = step(*state)
        if (i + 1) % CHECK_EVERY == 0 and not bool(state[-1].any()):
            break
    return state


def _solve(g, x_init, tol, max_steps, alpha, row_dims, dg=None, traced=False):
    """The bracketed, bisection-safeguarded Newton solve of ``g(x) = 0``.
    The loop conditions reduce over every axis after the first
    ``row_dims``: each leading row stops on its own (the JAX package's
    ``vmap`` of the loops), a single solve stops as a whole.  ``traced``
    runs both loops as ``while_loop`` operators (:func:`_loop`)."""
    rows = x_init.shape[:row_dims]
    trailing = (1,) * (x_init.ndim - row_dims)

    def per_row(v, op):
        return op(v.reshape(rows + (-1,)), dim=-1)

    def spread(flag):
        return flag.reshape(rows + trailing)

    def bracket(lo, hi, w, active):
        g_lo, g_hi = g(lo), g(hi)
        low = torch.where(torch.isnan(g_lo), -torch.inf, g_lo) > 0
        high = torch.where(torch.isnan(g_hi), torch.inf, g_hi) < 0
        active = active & per_row(low | high, torch.any)
        on = spread(active)
        return (torch.where(on & low, lo - w, lo), torch.where(on & high, hi + w, hi),
                torch.where(on, 2 * w, w), active)

    def newton(x, lo, hi, active):
        gx, slope = _value_and_slope(g, x, dg)
        err = per_row(torch.where(torch.isnan(gx), torch.inf, torch.abs(gx)), torch.amax)
        width = per_row(hi - lo, torch.amax)
        active = active & (err > tol) & (width > 0)
        on = spread(active)
        lo_n = torch.where(gx < 0, torch.maximum(lo, x), lo)
        hi_n = torch.where(gx > 0, torch.minimum(hi, x), hi)
        step = x - alpha * gx / slope
        bad = ~torch.isfinite(step) | (step <= lo_n) | (step >= hi_n)
        x_n = torch.where(bad, 0.5 * (lo_n + hi_n), step)
        return (torch.where(on, x_n, x), torch.where(on, lo_n, lo),
                torch.where(on, hi_n, hi), active)

    w = torch.clamp(torch.abs(x_init), min=1.0)
    active = torch.ones(rows, dtype=torch.bool, device=x_init.device)
    lo, hi, _, _ = _loop(bracket, (x_init - w, x_init + w, 2 * w, active), 64, traced)
    active = torch.ones(rows, dtype=torch.bool, device=x_init.device)
    x, _, _, _ = _loop(newton, (0.5 * (lo + hi), lo, hi, active), max_steps, traced)
    return x


def newton_inverse(func, z, tol=1e-6, max_steps=100, alpha=1.0, x0=None, row_dims=0,
                   dfunc=None):
    """Solve ``func(x) = z`` elementwise for x, ``func`` monotone increasing
    and elementwise (its Jacobian is diagonal).

    ``x0`` is the start (default 0).  With ``row_dims`` = k the first k
    axes of ``z`` are rows that stop on their own (hyperparameter rows that
    ``func`` maps with their own parameters); the JAX package gets the same
    from ``vmap``.  ``dfunc`` is the elementwise slope of ``func`` (autograd's
    when None).  Differentiable in ``z`` and in every tensor ``func`` closes
    over (see the module docstring)."""
    z = torch.as_tensor(z)

    def g(x):
        return func(x) - z

    start = (torch.zeros_like(z) if x0 is None
             else torch.broadcast_to(torch.as_tensor(x0, dtype=z.dtype, device=z.device),
                                     z.shape))
    with torch.no_grad():
        root = _solve(g, start, tol, max_steps, alpha, row_dims, dfunc,
                      torch.compiler.is_exporting())
    if not torch.is_grad_enabled():
        return root
    gx = g(root)
    if not gx.requires_grad:
        return root
    _, slope = _value_and_slope(g, root, dfunc)
    return root - (gx - gx.detach()) / slope
