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
sync per ``CHECK_EVERY`` steps instead of one per step.

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


def _value_and_slope(g, x):
    """``(g(x), g'(x))`` of an elementwise ``g``, both detached."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        gx = g(xg)
        (slope,) = torch.autograd.grad(gx.sum(), xg)
    return gx.detach(), slope


def _solve(g, x_init, tol, max_steps, alpha, row_dims):
    """The bracketed, bisection-safeguarded Newton solve of ``g(x) = 0``.
    The loop conditions reduce over every axis after the first
    ``row_dims``: each leading row stops on its own (the JAX package's
    ``vmap`` of the loops), a single solve stops as a whole."""
    rows = x_init.shape[:row_dims]
    trailing = (1,) * (x_init.ndim - row_dims)

    def per_row(v, op):
        return op(v.reshape(rows + (-1,)), dim=-1)

    def spread(flag):
        return flag.reshape(rows + trailing)

    active = torch.ones(rows, dtype=torch.bool, device=x_init.device)
    w = torch.clamp(torch.abs(x_init), min=1.0)
    lo, hi, w = x_init - w, x_init + w, 2 * w
    for i in range(64):
        g_lo, g_hi = g(lo), g(hi)
        low = torch.where(torch.isnan(g_lo), -torch.inf, g_lo) > 0
        high = torch.where(torch.isnan(g_hi), torch.inf, g_hi) < 0
        active = active & per_row(low | high, torch.any)
        on = spread(active)
        lo = torch.where(on & low, lo - w, lo)
        hi = torch.where(on & high, hi + w, hi)
        w = torch.where(on, 2 * w, w)
        if (i + 1) % CHECK_EVERY == 0 and not bool(active.any()):
            break

    x = 0.5 * (lo + hi)
    active = torch.ones(rows, dtype=torch.bool, device=x_init.device)
    for i in range(max_steps):
        gx, slope = _value_and_slope(g, x)
        err = per_row(torch.where(torch.isnan(gx), torch.inf, torch.abs(gx)), torch.amax)
        width = per_row(hi - lo, torch.amax)
        active = active & (err > tol) & (width > 0)
        on = spread(active)
        lo_n = torch.where(gx < 0, torch.maximum(lo, x), lo)
        hi_n = torch.where(gx > 0, torch.minimum(hi, x), hi)
        newton = x - alpha * gx / slope
        bad = ~torch.isfinite(newton) | (newton <= lo_n) | (newton >= hi_n)
        x_n = torch.where(bad, 0.5 * (lo_n + hi_n), newton)
        x = torch.where(on, x_n, x)
        lo = torch.where(on, lo_n, lo)
        hi = torch.where(on, hi_n, hi)
        if (i + 1) % CHECK_EVERY == 0 and not bool(active.any()):
            break
    return x


def newton_inverse(func, z, tol=1e-6, max_steps=100, alpha=1.0, x0=None, row_dims=0):
    """Solve ``func(x) = z`` elementwise for x, ``func`` monotone increasing
    and elementwise (its Jacobian is diagonal).

    ``x0`` is the start (default 0).  With ``row_dims`` = k the first k
    axes of ``z`` are rows that stop on their own (hyperparameter rows that
    ``func`` maps with their own parameters); the JAX package gets the same
    from ``vmap``.  Differentiable in ``z`` and in every tensor ``func``
    closes over (see the module docstring)."""
    z = torch.as_tensor(z)

    def g(x):
        return func(x) - z

    start = (torch.zeros_like(z) if x0 is None
             else torch.broadcast_to(torch.as_tensor(x0, dtype=z.dtype, device=z.device),
                                     z.shape))
    with torch.no_grad():
        root = _solve(g, start, tol, max_steps, alpha, row_dims)
    if not torch.is_grad_enabled():
        return root
    gx = g(root)
    if not gx.requires_grad:
        return root
    _, slope = _value_and_slope(g, root)
    return root - (gx - gx.detach()) / slope
