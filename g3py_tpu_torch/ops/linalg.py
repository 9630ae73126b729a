"""Robust dense linear algebra with analytic gradients (the PyTorch
counterpart of :mod:`g3py_tpu.ops.linalg`).

* Every factorization goes through :func:`~g3py_tpu_torch.ops.panel_cholesky.
  panel_cholesky` — the hand-written blocked Cholesky on the card, its plain
  version on the CPU — which also returns the inverses of its diagonal
  panels and a ``cholesky_ex``-style info flag.
* :func:`safe_cholesky` keeps the ``CholeskyRobust`` contract: never raise;
  one clean factorization, then a one-time repair of a non-positive
  diagonal plus escalating jitter ``mean(diag) * 1e-6 * 10**(k-1)`` for a
  bounded number of tries, and ``1e-10 * I`` on total failure.  Failure is
  read from the info flag together with a finiteness check of the factor
  (one host sync per try).  Its gradient is the Murray reverse-mode rule
  (arXiv:1602.07527), zero on failure.
* :func:`trtri_from_panels` builds L^{-1} by block forward substitution
  seeded with the panel inverses (the counterpart of the JAX package's
  ``blocked_trtri``).
* :func:`mvn_quad_logdet` returns ``(quad, logdet_half, ok)`` of a gaussian
  quadratic form.  Its value-only path whitens by a triangular solve; the
  differentiated path builds L^{-1} from the panels and its backward is the
  analytic ``dK = -g_q alpha alpha^T + 1/2 g_l K^{-1}``, ``dr = 2 g_q alpha``.
* :func:`mvn_loo` returns the leave-one-out terms of a gaussian (GPML
  eq. 5.10-5.12) from the same L^{-1}, with the analytic backward of GPML
  §5.4.2 (the JAX package differentiates through its Cholesky and
  ``blocked_trtri`` instead).

A stack of R matrices (R, n, n) — the hyperparameter rows of a sampler
step or of an averaged predictor — goes through :func:`safe_cholesky_panels`,
:func:`trtri_from_panels` and the value-only :func:`mvn_quad_logdet` as one
batch: one K2 factorization of all rows, then each retry re-factors only
the rows that failed, with their own diagonal fix and jitter, and one host
sync a try for the whole batch (the JAX package's ``vmap`` of
``_safe_cholesky_impl``); the differentiated :func:`mvn_quad_logdet` takes
the stack too, its backward batched over the rows.
"""

import torch

from ..config import settings
from .panel_cholesky import panel_cholesky

__all__ = ["safe_cholesky", "safe_cholesky_panels", "trtri_from_panels",
           "solve_lower_triangular", "solve_upper_triangular", "cho_solve",
           "log_det_from_chol", "mvn_quad_logdet", "mvn_loo"]

# block-column width of the K^{-1} = L^{-T} L^{-1} product (one tall
# matmul per block column, n^3/3 flops instead of the dense 2 n^3)
_KINV_BLOCK = 1024


def _jitter_plan(a):
    """``(base, diag_fix)`` of the escalation, per matrix of a stack:
    ``base = mean(diag) * jitter``; ``diag_fix`` lifts a non-positive
    diagonal to ``base``."""
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    base = diag.mean(dim=-1) * settings.cholesky_jitter
    dmin = diag.min(dim=-1).values
    return base, torch.where(dmin <= 0.0, base - dmin, torch.zeros_like(dmin))


def _failed_panels(dinv, dtype, device):
    """``1e10 * I`` panels, the panel inverses of the ``1e-10 * I`` factor."""
    eye = torch.eye(dinv.shape[-1], dtype=dtype, device=device)
    return (1e10 * eye).expand_as(dinv).contiguous()


def safe_cholesky_panels(a, max_tries=None):
    """Escalating-jitter factorization; returns ``(L, dinv, failed)`` with
    the panel inverses of the factorization that succeeded (``1e-10 * I``
    and ``1e10 * I`` panels on total failure).  The common case costs one
    factorization and one host sync.  A (R, n, n) stack is factored as one
    batch, each row with its own escalation, and ``failed`` is a (R,) bool
    tensor; a single matrix is the stack of one, and ``failed`` a bool.
    ``safe_cholesky_panels.retries`` counts the retry factorizations."""
    if max_tries is None:
        max_tries = settings.cholesky_max_tries
    single = a.ndim == 2
    a = (a[None] if single else a).detach()
    chol, dinv, info = panel_cholesky(a)
    ok = (info == 0) & torch.isfinite(chol).all(dim=-1).all(dim=-1)
    pending = torch.nonzero(~ok).flatten().cpu()  # the one sync of try 0
    if len(pending):
        # the non-positive diagonal is fixed once, before the escalation
        base, diag_fix = _jitter_plan(a)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        for k in range(1, max_tries):
            idx = pending.to(a.device)
            shift = diag_fix[idx] + base[idx] * 10.0 ** (k - 1)
            chol_k, dinv_k, info_k = panel_cholesky(a[idx] + shift[:, None, None] * eye)
            ok_k = (info_k == 0) & torch.isfinite(chol_k).all(dim=-1).all(dim=-1)
            chol[idx[ok_k]] = chol_k[ok_k]
            dinv[idx[ok_k]] = dinv_k[ok_k]
            pending = pending[~ok_k.cpu()]  # one sync a try
            safe_cholesky_panels.retries += 1
            if len(pending) == 0:
                break
        if len(pending):
            idx = pending.to(a.device)
            chol[idx] = 1e-10 * eye
            dinv[idx] = _failed_panels(dinv[idx], a.dtype, a.device)
    if single:
        return chol[0], dinv[0], len(pending) > 0
    failed = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    if len(pending):
        failed[pending.to(a.device)] = True
    return chol, dinv, failed


safe_cholesky_panels.retries = 0


class _SafeCholesky(torch.autograd.Function):
    """Robust factorization forward; Murray backward (JAX linalg.py:110-124).
    A (R, n, n) stack is factored as one batch and differentiated row by
    row in one batched backward, a failed row getting a zero gradient."""

    @staticmethod
    def forward(ctx, a, max_tries):
        chol, _, failed = safe_cholesky_panels(a, max_tries)
        ctx.failed = failed
        ctx.save_for_backward(chol)
        return chol

    @staticmethod
    def backward(ctx, chol_bar):
        (chol,) = ctx.saved_tensors
        if chol.ndim == 2 and ctx.failed:
            return torch.zeros_like(chol), None
        lt = chol.transpose(-1, -2)
        m = torch.matmul(lt, chol_bar)
        phi = torch.tril(m) - 0.5 * torch.diag_embed(torch.diagonal(m, dim1=-2, dim2=-1))
        # S = L^{-T} phi L^{-1} via two upper-triangular solves
        tmp = torch.linalg.solve_triangular(lt, phi.transpose(-1, -2), upper=True)
        s = torch.linalg.solve_triangular(lt, tmp.transpose(-1, -2), upper=True)
        a_bar = torch.tril(s + s.transpose(-1, -2)) - torch.diag_embed(
            torch.diagonal(s, dim1=-2, dim2=-1))
        # symmetrized, as d/dA of cholesky(A) for a full (square) input
        out = 0.5 * (a_bar + a_bar.transpose(-1, -2))
        if chol.ndim > 2:
            # a failed row's factor is 1e-10 I: its products overflow, so
            # its gradient is selected away, not multiplied by 0
            out = torch.where(ctx.failed[:, None, None], torch.zeros_like(out), out)
        return out, None


def safe_cholesky(a, max_tries=None):
    """Lower-triangular Cholesky that never fails.

    try 0:   ``cholesky(a)``
    try k>0: ``cholesky(a + diag_fix + mean(diag)*1e-6*10**(k-1) * I)`` where
             ``diag_fix`` lifts a non-positive diagonal to ``mean(diag)*1e-6``
    failure: ``1e-10 * I`` (and a zero gradient) after ``max_tries``
             attempts in all (``settings.cholesky_max_tries`` by default).
    """
    if max_tries is None:
        max_tries = settings.cholesky_max_tries
    return _SafeCholesky.apply(a, max_tries)


def _pad_tril(l, target):
    """Embed a lower-triangular L (or a stack of them) into a larger
    identity-padded triangle."""
    n = l.shape[-1]
    if target == n:
        return l
    out = torch.eye(target, dtype=l.dtype, device=l.device).repeat(l.shape[:-2] + (1, 1))
    out[..., :n, :n] = l
    return out


def trtri_from_panels(chol, dinv):
    """L^{-1} by block forward substitution seeded with the panel inverses
    ``dinv`` (``dinv[k] = L_kk^{-1}`` over the identity-padded panels):

      X[i,i] = dinv[i],   X[i,:i] = -dinv[i] (L[i,:i] X[:i,:i])

    — one block row per step, every product a plain matmul.  A stack
    (R, n, n) with its (R, nb, B, B) panels gives the R inverses, each
    step one batched product."""
    n = chol.shape[-1]
    nb, block = dinv.shape[-3], dinv.shape[-1]
    npad = nb * block
    lp = _pad_tril(chol, npad)
    x = torch.zeros(chol.shape[:-2] + (npad, npad), dtype=chol.dtype, device=chol.device)
    for i in range(nb):
        s = slice(i * block, (i + 1) * block)
        x[..., s, s] = dinv[..., i, :, :]
        if i:
            x[..., s, :s.start] = -torch.matmul(
                dinv[..., i, :, :], torch.matmul(lp[..., s, :s.start], x[..., :s.start, :s.start]))
    return x[..., :n, :n]


def _kinv_from_linv(linv, block=_KINV_BLOCK):
    """K^{-1} = L^{-T} L^{-1} for lower-triangular L^{-1} (or a stack of
    them, leading row axes): block column j of the upper half is
    ``W[j0:, :j1]^T W[j0:, j0:j1]`` (rows above j0 are zero in W), mirrored
    into the lower half."""
    n = linv.shape[-1]
    if n <= block:
        return torch.matmul(linv.transpose(-1, -2), linv)
    out = torch.empty_like(linv)
    for j0 in range(0, n, block):
        j1 = min(j0 + block, n)
        colblk = torch.matmul(linv[..., j0:, :j1].transpose(-1, -2), linv[..., j0:, j0:j1])
        out[..., :j1, j0:j1] = colblk
        out[..., j0:j1, :j0] = colblk[..., :j0, :].transpose(-1, -2)
    return out


def solve_lower_triangular(chol, b):
    """L x = b for a vector or matrix right-hand side (or stacks of both:
    a (R, m) right-hand side of an (R, m, m) factor is R vectors)."""
    if b.ndim == chol.ndim - 1:
        return torch.linalg.solve_triangular(chol, b[..., None], upper=False)[..., 0]
    return torch.linalg.solve_triangular(chol, b, upper=False)


def solve_upper_triangular(u, b):
    """U x = b for a vector or matrix right-hand side (or stacks of both)."""
    if b.ndim == u.ndim - 1:
        return torch.linalg.solve_triangular(u, b[..., None], upper=True)[..., 0]
    return torch.linalg.solve_triangular(u, b, upper=True)


def cho_solve(chol, b):
    """(L L^T)^{-1} b from the lower factor."""
    return solve_upper_triangular(chol.T, solve_lower_triangular(chol, b))


def log_det_from_chol(chol):
    """log det(A) = 2 * sum(log diag L)."""
    return 2.0 * torch.log(torch.diagonal(chol)).sum()


class _MvnQuadLogdet(torch.autograd.Function):
    """Differentiated path: L^{-1} from the panels, analytic backward
    (JAX linalg.py:477-518).  A (R, n, n) stack takes one batched
    factorization and one batched L^{-1}; its backward runs over the row
    axis (the JAX package's ``vmap`` of ``grad``), a failed row getting a
    zero gradient as a failed single matrix does.  A (n,) ``resid`` shared
    by every row gets the sum of the rows' gradients."""

    @staticmethod
    def forward(ctx, k, resid, max_tries):
        chol, dinv, failed = safe_cholesky_panels(k, max_tries)
        linv = trtri_from_panels(chol, dinv)
        rhs = resid.expand(linv.shape[:-1])
        z = torch.matmul(linv, rhs[..., None])[..., 0]
        ok = ((~failed) if k.ndim > 2 else torch.tensor(not failed, device=k.device)).to(k.dtype)
        ctx.failed = failed
        ctx.resid_shape = resid.shape
        ctx.save_for_backward(linv, z)
        ctx.mark_non_differentiable(ok)
        quad = (z * z).sum(dim=-1)
        logdet_half = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)
        return quad, logdet_half, ok

    @staticmethod
    def backward(ctx, g_quad, g_logdet, _g_ok):
        linv, z = ctx.saved_tensors
        need_k, need_r = ctx.needs_input_grad[:2]
        keep = (~ctx.failed if linv.ndim > 2
                else torch.tensor(not ctx.failed, device=linv.device))
        dk = dr = None
        # a failed row's factor is 1e-10 I: its products overflow float32,
        # so its gradient is selected away, not multiplied by 0
        alpha = torch.matmul(linv.transpose(-1, -2), z[..., None])[..., 0]
        if need_k:
            dk = ((0.5 * g_logdet)[..., None, None] * _kinv_from_linv(linv)
                  - g_quad[..., None, None] * (alpha[..., :, None] * alpha[..., None, :]))
            dk = torch.where(keep[..., None, None], dk, torch.zeros((), dtype=dk.dtype,
                                                                    device=dk.device))
        if need_r:
            dr = torch.where(keep[..., None], (2.0 * g_quad)[..., None] * alpha,
                             torch.zeros((), dtype=alpha.dtype, device=alpha.device))
            if len(ctx.resid_shape) < dr.ndim:  # one residual shared by every row
                dr = dr.sum(dim=tuple(range(dr.ndim - len(ctx.resid_shape))))
        return dk, dr, None


def mvn_quad_logdet(k, resid, max_tries=None):
    """``(quad, logdet_half, ok)`` for a gaussian quadratic form:

      quad        = resid^T K^{-1} resid
      logdet_half = sum log diag chol(K)  (= 1/2 log det K)
      ok          = 0.0 when the robust factorization fell back, else 1.0

    Differentiable in ``k`` and ``resid`` (analytic backward, zero on
    failure); without gradients it whitens by one triangular solve.  A
    (R, n, n) ``k`` (with a (R, n) or (n,) ``resid``) gives (R,) values
    from one batched factorization, and under grad one batched L^{-1}
    from the same factorization's panels for the backward."""
    if max_tries is None:
        max_tries = settings.cholesky_max_tries
    single = k.ndim == 2
    if torch.is_grad_enabled() and (k.requires_grad or resid.requires_grad):
        return _MvnQuadLogdet.apply(k, resid, max_tries)
    stack = k[None] if single else k
    chol, _, failed = safe_cholesky_panels(stack, max_tries)
    rhs = resid.expand(stack.shape[:-1])[..., None]
    z = torch.linalg.solve_triangular(chol, rhs, upper=False)[..., 0]
    quad = (z * z).sum(dim=-1)
    logdet_half = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)
    ok = (~failed).to(k.dtype)
    return (quad[0], logdet_half[0], ok[0]) if single else (quad, logdet_half, ok)


class _MvnLoo(torch.autograd.Function):
    """Leave-one-out terms from L^{-1} (built from K2's panel inverses) and
    their analytic backward: with ``Kinv = L^{-T} L^{-1}``, ``alpha = Kinv
    r`` and ``kd = diag(Kinv)``,

      f      = sum_i 1/2 log kd_i - 1/2 alpha_i^2 / kd_i
      r_bar  = Kinv g_alpha
      K_bar  = -sym((Kinv g_alpha) alpha^T) - Kinv diag(g_kd) Kinv

    with ``g_alpha = -alpha / kd`` and ``g_kd = 1/2 (1/kd + alpha^2/kd^2)``
    (GPML §5.4.2, eq. 5.13); zero for K on a failed factorization.  A (R,
    n, n) stack (with a (R, n) or (n,) ``resid``) takes one batched
    factorization and gives (R,) values, each row's gradient its own."""

    @staticmethod
    def forward(ctx, k, resid, max_tries):
        chol, dinv, failed = safe_cholesky_panels(k, max_tries)
        linv = trtri_from_panels(chol, dinv)
        rhs = resid.expand(linv.shape[:-1])[..., None]
        alpha = torch.matmul(linv.transpose(-1, -2), torch.matmul(linv, rhs))[..., 0]
        kd_raw = (linv * linv).sum(dim=-2)
        kd = torch.clamp(kd_raw, min=1e-30)
        total = (0.5 * torch.log(kd) - 0.5 * alpha * alpha / kd).sum(dim=-1)
        finite = torch.isfinite(alpha).all(dim=-1)
        ctx.failed = failed
        ctx.resid_shape = resid.shape
        ctx.save_for_backward(linv, alpha, kd, kd_raw > 1e-30)
        ctx.mark_non_differentiable(finite)
        return total, finite

    @staticmethod
    def backward(ctx, g_total, _g_finite):
        linv, alpha, kd, unclipped = ctx.saved_tensors
        need_k, need_r = ctx.needs_input_grad[:2]
        kinv = _kinv_from_linv(linv)
        g_total = g_total[..., None]
        g_alpha = -g_total * alpha / kd
        g_kd = torch.where(unclipped, 0.5 * g_total * (1.0 / kd + alpha * alpha / (kd * kd)),
                           torch.zeros_like(kd))
        kinv_ga = torch.matmul(kinv, g_alpha[..., None])[..., 0]
        dk = dr = None
        if need_k:
            outer = kinv_ga[..., :, None] * alpha[..., None, :]
            dk = -0.5 * (outer + outer.transpose(-1, -2)) - torch.matmul(
                kinv * g_kd[..., None, :], kinv)
            keep = (~ctx.failed if linv.ndim > 2
                    else torch.tensor(not ctx.failed, device=linv.device))
            dk = torch.where(keep[..., None, None], dk, torch.zeros_like(dk))
        if need_r:
            dr = kinv_ga
            if len(ctx.resid_shape) < dr.ndim:  # one residual shared by every row
                dr = dr.sum(dim=tuple(range(dr.ndim - len(ctx.resid_shape))))
        return dk, dr, None


def mvn_loo(k, resid, max_tries=None):
    """``(total, finite)``: the leave-one-out log predictive terms of a
    gaussian with covariance ``k`` and residual ``resid`` (GPML eq.
    5.10-5.12, without the -n/2 log 2pi constant),

      total  = sum_i 1/2 log [K^{-1}]_ii - 1/2 [K^{-1} r]_i^2 / [K^{-1}]_ii

    and whether ``K^{-1} r`` is finite.  One factorization serves every
    fold; differentiable in ``k`` and ``resid`` (analytic backward); a (R,
    n, n) ``k`` gives (R,) values from one batched factorization."""
    if max_tries is None:
        max_tries = settings.cholesky_max_tries
    return _MvnLoo.apply(k, resid, max_tries)
