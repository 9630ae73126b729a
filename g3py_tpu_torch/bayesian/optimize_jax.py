"""Multi-start L-BFGS MAP training on the device, the engine behind
``find_MAP(engine='jax')`` (the PyTorch counterpart of
:mod:`g3py_tpu.bayesian.optimize_jax`; the module keeps the JAX package's
name because the API calls the engine ``'jax'``).

The JAX package ``vmap``-s ``optax.lbfgs()`` over the starts.  Here every
start is a row of one batched L-BFGS: memory 10, the scaled initial
preconditioner (``min(1, 1/|g|)`` at the first step, ``s'y / y'y`` after),
and a line search that accepts a step on the strong Wolfe conditions (slope
tolerance 1e-4, curvature 0.9) or Hager and Zhang's approximate ones, from a
first guess of 1, doubling to bracket and then zooming by safeguarded cubic
interpolation, at most 20 evaluations.  Each evaluation of the objective is
one batched value-and-gradient call over the starts that are still
searching; the line searches' bookkeeping runs on the host (one read of
the values and slopes an evaluation).  A start stops when max|g| <= ``tol``,
when its line search finds no decrease, or at ``max_iters``.

:func:`lbfgs_minimize_guarded` is the device loop of
``find_MAP(engine='iterative', loop='device')``: the same pieces on one
start at a time, against an objective whose trust signal (the matrix-free
NLL's CG residual) guards it.
"""

import math

import numpy as np
import torch

from ..config import settings
from .samplers import value_and_grad

__all__ = ["lbfgs_maximize", "lbfgs_minimize_guarded"]

_MEMORY = 10
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
_MAX_LINESEARCH_STEPS = 20


def _wolfe(f0, s0, a, f, s):
    """(sufficient decrease, curvature) of step ``a`` with value ``f`` and
    slope ``s``, as optax's zoom line search tests them."""
    armijo = f - f0 - _SLOPE_RTOL * a * s0
    approx = max(s - (2 * _SLOPE_RTOL - 1.0) * s0, f - f0 - _APPROX_DEC_RTOL * abs(f0))
    dec = min(armijo, approx)
    return (not math.isnan(dec) and dec <= 0.0), abs(s) <= _CURV_RTOL * abs(s0)


def _cubic(a_lo, f_lo, s_lo, a_hi, f_hi, s_hi):
    """Minimizer of the cubic through both ends, safeguarded to the middle
    80% of the interval (bisection otherwise)."""
    lo, hi = min(a_lo, a_hi), max(a_lo, a_hi)
    width = hi - lo
    try:
        d1 = s_lo + s_hi - 3.0 * (f_lo - f_hi) / (a_lo - a_hi)
        d2 = math.copysign(math.sqrt(d1 * d1 - s_lo * s_hi), a_hi - a_lo)
        a = a_hi - (a_hi - a_lo) * (s_hi + d2 - d1) / (s_hi - s_lo + 2.0 * d2)
    except (ValueError, ZeroDivisionError, OverflowError):
        a = math.nan
    if not (math.isfinite(a) and lo + 0.1 * width <= a <= hi - 0.1 * width):
        a = 0.5 * (lo + hi)
    return a


def _line_search(f0, s0, max_steps=_MAX_LINESEARCH_STEPS):
    """One start's line search along a descent direction (slope ``s0`` < 0
    at step 0, value ``f0``), as a generator: it yields a step, receives
    ``(value, slope, payload)`` of that step, and returns ``(step,
    payload)`` of the step it accepts (``(0, None)`` when none
    decreases); at most ``max_steps`` evaluations."""
    lo = (0.0, f0, s0, None)
    a, steps = 1.0, 0
    hi = None
    while steps < max_steps:  # bracketing
        f, s, pay = yield a
        steps += 1
        dec, curv = _wolfe(f0, s0, a, f, s)
        if not dec or (steps > 1 and f >= lo[1]):
            hi = (a, f, s, pay)
            break
        if curv:
            return a, pay
        if s >= 0:
            hi, lo = lo, (a, f, s, pay)
            break
        lo = (a, f, s, pay)
        a *= 2.0
    while hi is not None and steps < max_steps:  # zoom
        a = _cubic(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])
        f, s, pay = yield a
        steps += 1
        dec, curv = _wolfe(f0, s0, a, f, s)
        if not dec or f >= lo[1]:
            hi = (a, f, s, pay)
        else:
            if curv:
                return a, pay
            if s * (hi[0] - lo[0]) >= 0:
                hi = lo
            lo = (a, f, s, pay)
        if abs(hi[0] - lo[0]) <= 1e-12 * max(1.0, abs(lo[0])):
            break
    return lo[0], lo[3]


def _direction(g, mem_s, mem_y, mem_rho, gamma):
    """-H g by the two-loop recursion over the (starts, memory, ndim)
    chronological memory (unused slots are zero and drop out)."""
    q = g.clone()
    alphas = []
    for i in reversed(range(mem_s.shape[1])):
        alpha = mem_rho[:, i] * (mem_s[:, i] * q).sum(-1)
        q = q - alpha[:, None] * mem_y[:, i]
        alphas.append(alpha)
    r = gamma[:, None] * q
    for i, alpha in zip(range(mem_s.shape[1]), reversed(alphas)):
        beta = mem_rho[:, i] * (mem_y[:, i] * r).sum(-1)
        r = r + (alpha - beta)[:, None] * mem_s[:, i]
    return -r


def lbfgs_maximize(logp_fn, starts, max_iters=200, tol=1e-5, with_rows=False):
    """Maximize a batched log density ``logp_fn`` ((R, ndim) tensor -> (R,),
    differentiable by torch autograd) from every row of ``starts`` at once.
    With ``with_rows`` it is called as ``logp_fn(u, rows)``: ``rows`` is the
    (R,) index tensor of the start each row of ``u`` belongs to (the line
    searches evaluate the starts still searching, a subset), so that an
    objective with a payload per start (a split's mask) picks its own.

    The objective is -logp with a non-finite value read as 1e30 (and its
    gradient as 0); a step that lands on non-finite parameters is rejected
    and its start stops, as in the JAX package.  Returns host arrays
    ``(points (k, ndim), values (k,))``; ``lbfgs_maximize.evaluations``
    counts the batched evaluations and ``lbfgs_maximize.iterations`` the
    L-BFGS iterations of the last call."""
    x = torch.as_tensor(np.atleast_2d(np.asarray(starts, settings.floatx)),
                        device=settings.device)
    k, ndim = x.shape
    lbfgs_maximize.evaluations = 0

    def objective(pts, rows=None):
        lbfgs_maximize.evaluations += 1
        if with_rows:
            rows = torch.arange(k, device=x.device) if rows is None else rows
            v, g = value_and_grad(lambda u: logp_fn(u, rows), pts)
        else:
            v, g = value_and_grad(logp_fn, pts)
        finite = torch.isfinite(v)
        return (torch.where(finite, -v, torch.full_like(v, 1e30)),
                torch.where(finite[:, None], -g, torch.zeros_like(g)))

    f, g = objective(x)
    mem_s = x.new_zeros((k, _MEMORY, ndim))
    mem_y = torch.zeros_like(mem_s)
    mem_rho = x.new_zeros((k, _MEMORY))
    x_prev, g_prev = x.clone(), g.clone()
    count = 0
    active = (g.abs().amax(dim=-1) > tol).cpu().numpy()
    it = 0
    while it < max_iters and active.any():
        # 1. the memory and the initial scaling (optax's scale_by_lbfgs)
        if count > 0:
            s, y = x - x_prev, g - g_prev
            sy = (s * y).sum(-1)
            rho = torch.where(sy == 0, torch.zeros_like(sy), 1.0 / sy)
            upd = torch.as_tensor(active, device=x.device)
            mem_s = torch.where(upd[:, None, None], torch.cat([mem_s[:, 1:], s[:, None]], 1),
                                mem_s)
            mem_y = torch.where(upd[:, None, None], torch.cat([mem_y[:, 1:], y[:, None]], 1),
                                mem_y)
            mem_rho = torch.where(upd[:, None], torch.cat([mem_rho[:, 1:], rho[:, None]], 1),
                                  mem_rho)
            yy = (y * y).sum(-1)
            gamma = torch.where(yy > 0, sy / torch.where(yy > 0, yy, torch.ones_like(yy)),
                                torch.ones_like(yy))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0)
        d = _direction(g, mem_s, mem_y, mem_rho, gamma)
        slope0 = (g * d).sum(-1)
        # a direction that does not descend (negative curvature in the
        # memory): steepest descent, memory cleared
        bad = (slope0 >= 0) | ~torch.isfinite(slope0)
        if bool(bad.any()):
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0)
            d = torch.where(bad[:, None], -scale[:, None] * g, d)
            keep = ~bad
            mem_s, mem_y = mem_s * keep[:, None, None], mem_y * keep[:, None, None]
            mem_rho = mem_rho * keep[:, None]
            slope0 = (g * d).sum(-1)
        # 2. the line searches, every searching start in one evaluation
        f0, s0 = f.cpu().numpy(), slope0.cpu().numpy()
        searches, steps, done = {}, {}, {}
        for i in np.flatnonzero(active):
            searches[i] = _line_search(float(f0[i]), float(s0[i]))
            steps[i] = next(searches[i])
        while steps:
            idx = sorted(steps)
            rows = torch.as_tensor(idx, device=x.device)
            alpha = torch.as_tensor([steps[i] for i in idx], dtype=x.dtype, device=x.device)
            pts = x[rows] + alpha[:, None] * d[rows]
            fv, gv = objective(pts, rows)
            sv = (gv * d[rows]).sum(-1)
            host = torch.stack([fv, sv]).cpu().numpy()
            for j, i in enumerate(idx):
                try:
                    steps[i] = searches[i].send((float(host[0, j]), float(host[1, j]),
                                                 (pts[j], fv[j], gv[j])))
                except StopIteration as stop:
                    done[i] = stop.value
                    del steps[i]
        # 3. the step (a rejected or empty one stops its start)
        x_prev, g_prev = x.clone(), g.clone()
        for i, (a, pay) in done.items():
            if pay is None or not bool(torch.isfinite(pay[0]).all()):
                g[i] = 0.0
                active[i] = False
                continue
            x[i], f[i], g[i] = pay
        count += 1
        it += 1
        active &= (g.abs().amax(dim=-1) > tol).cpu().numpy()
    lbfgs_maximize.iterations = it
    return x.cpu().numpy(), (-f).cpu().numpy()


lbfgs_maximize.evaluations = 0
lbfgs_maximize.iterations = 0


def lbfgs_minimize_guarded(obj_fn, starts, max_iters=200, chunk=8, tol=1e-5, resid_tol=5e-2,
                           display=False, linesearch_steps=None, dispatch_budget=None):
    """L-BFGS on the device for guarded stochastic-estimator objectives, one
    start at a time.  ``obj_fn(u) -> (value, trust_residual)`` takes a
    (ndim,) tensor and is differentiable by torch autograd (e.g. the
    matrix-free NLL, whose CG relative residual is the trust signal).

    The hardening of the JAX package's engine: a point with a non-finite
    value or ``trust_residual > resid_tol`` reads as 1e10 with a zero
    gradient, the zero selected (``torch.where``), never multiplied, so a
    NaN gradient there cannot leak; a step that lands non-finite, at a
    guarded value (>= 1e9) or with a non-finite gradient is rejected, and
    the memory is reset at the unchanged iterate (the next direction is
    steepest descent: a restored memory would retry the same step).  A run
    stops at max|g| < ``tol``, a non-finite gradient, ``max_iters``
    iterations, or after two flat iterations in a row (value change below
    1e-7 relative).  ``linesearch_steps`` caps the line search's
    evaluations; ``chunk`` and ``dispatch_budget`` are accepted and change
    nothing (every iteration is a chunk of one; they size the JAX
    package's jitted dispatches).

    Returns host arrays ``(points (k, ndim), values (k,), iters (k,))``:
    the values are the guarded objective (1e10 marks a start that never
    reached a trusted point).  ``lbfgs_minimize_guarded.evaluations``
    counts the objective evaluations of the last call."""
    starts = np.atleast_2d(np.asarray(starts, settings.floatx))
    max_ls = _MAX_LINESEARCH_STEPS if linesearch_steps is None else int(linesearch_steps)
    lbfgs_minimize_guarded.evaluations = 0

    def value_and_grad(u):
        lbfgs_minimize_guarded.evaluations += 1
        u = u.detach().requires_grad_(True)
        with torch.enable_grad():
            v, resid = obj_fn(u)
            (g,) = torch.autograd.grad(v, u)
        ok = torch.isfinite(v.detach()) & (torch.as_tensor(resid).detach() <= resid_tol)
        return (torch.where(ok, v.detach(), torch.full_like(v.detach(), 1e10)),
                torch.where(ok, g, torch.zeros_like(g)))

    points, values, iters = [], [], []
    for x0 in starts:
        x = torch.as_tensor(x0, device=settings.device)[None]
        ndim = x.shape[1]
        v, g = value_and_grad(x[0])
        v, g = v.reshape(1), g[None]
        mem_s = x.new_zeros((1, _MEMORY, ndim))
        mem_y, mem_rho = torch.zeros_like(mem_s), x.new_zeros((1, _MEMORY))
        fresh = True
        it, v_prev, flat = 0, float("inf"), 0
        while it < max_iters:
            gamma = (torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0) if fresh
                     else _gamma(mem_s[:, -1], mem_y[:, -1]))
            d = _direction(g, mem_s, mem_y, mem_rho, gamma)
            slope0 = float((g * d).sum())
            if not (slope0 < 0):  # no descent: steepest descent, memory cleared
                mem_s.zero_(), mem_y.zero_(), mem_rho.zero_()
                d = -torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0) * g
                slope0 = float((g * d).sum())
            search = _line_search(float(v), slope0, max_ls)
            step = next(search)
            try:
                while True:
                    pt = x + step * d
                    fv, gv = value_and_grad(pt[0])
                    step = search.send((float(fv), float((gv * d[0]).sum()), (pt, fv, gv)))
            except StopIteration as stop:
                _, pay = stop.value
            ok = pay is not None
            if ok:
                x_new, v_new, g_new = pay[0], pay[1].reshape(1), pay[2][None]
                ok = (bool(torch.isfinite(v_new).all()) and float(v_new) < 1e9
                      and bool(torch.isfinite(x_new).all())
                      and bool(torch.isfinite(g_new).all()))
            if ok:
                s_k, y_k = x_new - x, g_new - g
                sy = (s_k * y_k).sum(-1)
                rho = torch.where(sy == 0, torch.zeros_like(sy), 1.0 / sy)
                mem_s = torch.cat([mem_s[:, 1:], s_k[:, None]], 1)
                mem_y = torch.cat([mem_y[:, 1:], y_k[:, None]], 1)
                mem_rho = torch.cat([mem_rho[:, 1:], rho[:, None]], 1)
                x, v, g, fresh = x_new, v_new, g_new, False
            else:  # rejected: reset the memory at the unchanged iterate
                mem_s, mem_y, mem_rho = (torch.zeros_like(mem_s), torch.zeros_like(mem_y),
                                         torch.zeros_like(mem_rho))
                fresh = True
            it += 1
            v_host, gmax = float(v), float(g.abs().max())
            if display:
                print(f"  iter {it}: value {v_host:.6g} |g|max {gmax:.3g}", flush=True)
            if not np.isfinite(gmax) or gmax < tol:
                break
            if abs(v_prev - v_host) < 1e-7 * max(1.0, abs(v_host)):
                # two flat iterations in a row: a single flat one may be a
                # rejected step whose reset has not had its retry yet
                flat += 1
                if flat >= 2:
                    break
            else:
                flat = 0
            v_prev = v_host
        points.append(x[0].detach().cpu().numpy().astype(settings.floatx))
        values.append(float(v))
        iters.append(it)
    return np.stack(points), np.asarray(values), np.asarray(iters)


def _gamma(s, y):
    """The initial scaling s'y / y'y of the newest memory pair (1 where
    y'y = 0)."""
    sy, yy = (s * y).sum(-1), (y * y).sum(-1)
    return torch.where(yy > 0, sy / torch.where(yy > 0, yy, torch.ones_like(yy)),
                       torch.ones_like(yy))


lbfgs_minimize_guarded.evaluations = 0
