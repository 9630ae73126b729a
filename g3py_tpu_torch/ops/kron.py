"""Kronecker-structured exact GP algebra for Cartesian-product grids, the
masked (incomplete-grid) and SKI (scattered rows on an inducing grid)
matrix-free operators (the PyTorch counterpart of
:mod:`g3py_tpu.ops.kron`).

When the inputs form a full grid ``X = axes_1 x ... x axes_D`` and the
kernel is separable, the gram is ``K = K_1 (x) ... (x) K_D`` and exact GP
inference costs the per-axis eigendecompositions plus ``O(N sum_i n_i)``
tensor contractions (Saatci 2011).  :func:`kron_gp_nll` is a
``torch.autograd.Function`` whose backward is eigh-free,

    dNLL/dK_i = 1/2 ( Q_i diag(w_i) Q_i'  -  unfold_i(a) unfold_i(b_i)' ),

with ``w_i`` a reduction of the Kronecker eigenvalue field and ``b_i`` the
alpha tensor contracted with the other axes' grams: autograd through
``eigh`` divides by eigenvalue gaps, which the clustered spectra of smooth
grams make blow up.

With missing cells the observed block is no longer eigen-diagonalizable
but its matvec still is (scatter, per-axis contractions, gather);
:func:`masked_kron_nll` runs it through the matrix-free stack of
:mod:`g3py_tpu_torch.ops.iterative` (pivoted-Cholesky Woodbury
preconditioner, PCG quadratic form, SLQ log-determinant, the BBMM
stochastic-trace backward).  SKI (Wilson & Nickisch 2015) interpolates
scattered rows onto a uniform grid with cubic-convolution taps, K ~ W K_uu
W'; its operator is a gather (W g) and an ``index_add_`` (W' v) over one
fused table of 4^D taps a row.  ``index_add_`` on the card sums in no fixed
order, so W' v there differs from the CPU's by float rounding (a replay
holds it within a stated tolerance).  The JAX package's dense-W TPU
densifications (``ski_mxu*``, ``ski_probe_chunk``) are not carried over,
and ``shard=`` (a device mesh) comes with item 16.

The draws of the estimators (``seed``) are an int (generators seeded with
``seed`` and ``seed + 104729``, as the JAX package keys its probe streams),
a ``torch.Generator`` or a dict of the (probes, n) draws ``slq`` and
``grad``.  Every product is full FP32 (TF32 stalls CG).
"""

import numpy as np
import torch

from . import iterative as it
from .iterative import full_fp32

__all__ = ["kron_apply", "kron_gp_nll", "kron_eigs", "kron_dinv", "kron_solve_eig",
           "cross_mean", "cross_var", "cross_cov", "masked_kron_matvec", "masked_kron_nll",
           "masked_cross_solve", "cubic_interp_axis", "ski_wv", "ski_wtv", "ski_dense_w",
           "ski_operator", "ski_prior_diag", "ski_nll", "ski_solve", "LOG2PI"]

LOG2PI = float(np.log(2.0 * np.pi))

_NO_SHARD = ("a device-sharded Kronecker NLL (shard=) is not ported yet (ROADMAP Queue 1 "
             "item 16)")


def _apply_axis(mat, tensor, axis):
    """Contract ``mat`` (m, n_axis) against ``tensor`` along ``axis``; the
    result carries m at that axis (trailing batch axes ride along)."""
    moved = tensor.movedim(axis, -1)
    with full_fp32():
        out = torch.matmul(moved, mat.transpose(-1, -2))
    return out.movedim(-1, axis)


def kron_apply(mats, tensor):
    """Apply ``(x)_i mats[i]`` to the tensor-shaped vector: one
    contraction an axis (``mats[i]`` may be rectangular)."""
    for i, m in enumerate(mats):
        tensor = _apply_axis(m, tensor, i)
    return tensor


def kron_eigs(ks):
    """Per-axis symmetric eigendecompositions of the factor grams, the
    eigenvalues clamped at zero (the noise added downstream regularizes):
    ``(qs, lams)``."""
    qs, lams = [], []
    with full_fp32():
        for k in ks:
            lam, q = torch.linalg.eigh(0.5 * (k + k.transpose(-1, -2)))
            lams.append(torch.clamp(lam, min=0.0))
            qs.append(q)
    return qs, lams


def _lam_field(lams, skip=None):
    """The (n_1, ..., n_D) tensor ``prod_{i != skip} lam_i`` by
    broadcasting (never by dividing the full product)."""
    nd = len(lams)
    out = None
    for i, lam in enumerate(lams):
        if i == skip:
            continue
        shape = [1] * nd
        shape[i] = lam.shape[0]
        piece = lam.reshape(shape)
        out = piece if out is None else out * piece
    full = tuple(lam.shape[0] for lam in lams)
    if out is None:   # D == 1 with skip == 0
        return torch.ones(full, dtype=lams[0].dtype, device=lams[0].device)
    return out.expand(full)


def kron_dinv(lams, sigma2):
    """1 / (prod_i lam_i + sigma2) as the (n_1, ..., n_D) tensor."""
    return 1.0 / (_lam_field(lams) + sigma2)


def kron_solve_eig(qs, dinv, y):
    """(K + s2 I)^{-1} y through the eigen representation Q D^{-1} Q' y."""
    yt = kron_apply([q.T for q in qs], y)
    return kron_apply(qs, yt * dinv)


# ---------------------------------------------------------------------------
# the marginal likelihood of a complete grid
# ---------------------------------------------------------------------------


class _KronNLL(torch.autograd.Function):
    """The exact Kronecker NLL with the analytic, eigh-free backward."""

    @staticmethod
    def forward(ctx, y, sigma2, *ks):
        with torch.no_grad():
            qs, lams = kron_eigs(ks)
            dinv = kron_dinv(lams, sigma2)
            yt = kron_apply([q.T for q in qs], y)
            at = yt * dinv                                  # D^{-1} Q' y
            nll = 0.5 * (-torch.log(dinv).sum() + (yt * at).sum() + y.numel() * LOG2PI)
        ctx.nd = len(ks)
        ctx.save_for_backward(dinv, at, *qs, *lams, *ks)
        return nll

    @staticmethod
    def backward(ctx, ct):
        nd = ctx.nd
        dinv, at, *rest = ctx.saved_tensors
        qs, lams, ks = rest[:nd], rest[nd:2 * nd], rest[2 * nd:]
        with torch.no_grad(), full_fp32():
            alpha = kron_apply(list(qs), at)                # S^{-1} y
            g_y = ct * alpha
            # d/ds2: 1/2 tr S^{-1} - 1/2 |alpha|^2 (= |at|^2, Q orthogonal)
            g_s2 = ct * 0.5 * (dinv.sum() - (at * at).sum())
            g_ks = []
            for i in range(nd):
                other = [a for a in range(nd) if a != i]
                pi = _lam_field(lams, skip=i) if nd > 1 else torch.ones_like(dinv)
                w = (pi * dinv).sum(dim=other) if other else pi * dinv
                tr_mat = torch.matmul(qs[i] * w[None, :], qs[i].T)
                beta = alpha
                for j in other:
                    beta = _apply_axis(ks[j], beta, j)
                a_mat = alpha.movedim(i, 0).reshape(alpha.shape[i], -1)
                b_mat = beta.movedim(i, 0).reshape(alpha.shape[i], -1)
                g_ks.append(ct * 0.5 * (tr_mat - torch.matmul(a_mat, b_mat.T)))
        return (g_y if ctx.needs_input_grad[0] else None,
                g_s2 if ctx.needs_input_grad[1] else None, *g_ks)


def kron_gp_nll(ks, sigma2, y, shard=None):
    """Exact negative log marginal likelihood of ``y ~ N(0, (x)K_i + sigma2
    I)`` for a tensor-shaped ``y`` (n_1, ..., n_D); ``ks`` the per-axis
    grams.  Differentiable in the grams, the noise and ``y`` through the
    analytic eigh-free backward (module docstring)."""
    if shard is not None:
        raise NotImplementedError(_NO_SHARD)
    sigma2 = torch.as_tensor(sigma2, dtype=y.dtype, device=y.device)
    return _KronNLL.apply(y, sigma2, *ks)


# ---------------------------------------------------------------------------
# posterior statistics at arbitrary (paired) query rows
# ---------------------------------------------------------------------------


def _batched_contract(mats, tensor):
    """Per-query contraction: mats[i] is (M, n_i); returns (M,) values
    sum_idx prod_i mats[i][m, idx_i] tensor[idx]."""
    with full_fp32():
        t = torch.tensordot(mats[0], tensor, dims=([1], [0]))          # (M, n_2..n_D)
        for c in mats[1:]:
            t = torch.einsum("ma...,ma->m...", t, c)
    return t


def cross_mean(cs, alpha):
    """Posterior mean at M query rows: the Khatri-Rao cross-gram rows of
    the per-axis cross grams ``cs[i]`` (M, n_i) against the solved
    ``alpha`` (n_1..n_D)."""
    return _batched_contract(cs, alpha)


def cross_var(cs, qs, dinv, kdiag):
    """Posterior marginal variance at M query rows: ``kdiag - sum_idx
    (prod_i (C_i Q_i)[m, idx_i])^2 dinv[idx]``."""
    with full_fp32():
        gs = [torch.matmul(c, q) for c, q in zip(cs, qs)]
    red = _batched_contract([g * g for g in gs], dinv)
    return torch.clamp(kdiag - red, min=0.0)


def cross_cov(cs, qs, dinv, kqq, chunk=65536):
    """Full (M, M) posterior covariance at the query rows, ``K_** - V
    D^{-1} V'`` with ``V[m, idx] = prod_i (C_i Q_i)[m, idx_i]``, assembled
    ``chunk`` flattened grid cells at a time."""
    with full_fp32():
        gs = [torch.matmul(c, q) for c, q in zip(cs, qs)]
        dflat = dinv.reshape(-1)
        n, shape = dflat.shape[0], dinv.shape
        red = None
        for lo in range(0, n, chunk):
            idx = torch.arange(lo, min(lo + chunk, n), device=dflat.device)
            multi = torch.unravel_index(idx, shape)
            v = gs[0][:, multi[0]]
            for g, ix in zip(gs[1:], multi[1:]):
                v = v * g[:, ix]
            part = torch.matmul(v * dflat[idx][None, :], v.T)
            red = part if red is None else red + part
    return kqq - red


# ---------------------------------------------------------------------------
# the matrix-free NLL shared by the masked grid and SKI
# ---------------------------------------------------------------------------


class _Op:
    """A noise-free gram operator K(ks) of the matrix-free NLL: ``kmv(ks,
    v)`` (v (n,) or (n, k)), ``diag(ks)``, ``column(ks, j)`` (j a 0-d long
    tensor) and ``bilinear(ks, c, w) = sum(c * K w)``, differentiable in
    ``ks``."""

    def kmv(self, ks, v):
        raise NotImplementedError

    def diag(self, ks):
        raise NotImplementedError

    def column(self, ks, j):
        raise NotImplementedError

    def bilinear(self, ks, c, w):
        return (c * self.kmv(ks, w)).sum()


def _preconditioner(op, ks, sigma2, rank):
    l_factor = it.pivoted_cholesky(lambda j: op.column(ks, j), op.diag(ks), rank)
    return l_factor, it.woodbury_preconditioner(l_factor, sigma2)


def _matvec(op, ks, sigma2):
    return lambda v: op.kmv(ks, v) + sigma2 * v


def _op_pieces(op, ks, sigma2, y, rank, cg_iters, lanczos_iters, zs):
    """The forward: ``(nll, info, alpha, l_factor)``, no graph."""
    n = y.shape[0]
    mv = _matvec(op, ks, sigma2)
    l_factor, (p_inv, p_inv_sqrt, logdet_p) = _preconditioner(op, ks, sigma2, rank)
    alpha = it.pcg_solve(mv, y, p_inv, maxiter=cg_iters)
    with full_fp32():
        quad = torch.dot(y, alpha)

    def precond_op(v):
        return p_inv_sqrt(mv(p_inv_sqrt(v)))

    logdet = logdet_p + it.slq_logdet(precond_op, n, zs, lanczos_iters=lanczos_iters)
    nll = 0.5 * (quad + logdet + n * LOG2PI)
    with full_fp32():
        rel = torch.linalg.vector_norm(mv(alpha) - y) / torch.clamp(
            torch.linalg.vector_norm(y), min=1e-30)
    return nll, {"quad": quad, "logdet": logdet, "cg_rel_residual": rel}, alpha, l_factor


class _OpNLL(torch.autograd.Function):
    """The matrix-free NLL with the BBMM stochastic-trace backward:

        dNLL/dth = 1/2 mean_i (S^{-1} z_i)' dS z_i - 1/2 a' dS a,

    the probe solves by PCG (each probe a column, frozen once it stops),
    the directional derivatives by autograd through the operator's
    ``bilinear``.  The diagnostics take no gradient."""

    @staticmethod
    def forward(ctx, cfg, y, sigma2, *ks):
        op, rank, cg_iters, lanczos_iters, zs, zg = cfg
        with torch.no_grad():
            nll, info, alpha, l_factor = _op_pieces(op, ks, sigma2, y, rank, cg_iters,
                                                    lanczos_iters, zs)
        ctx.cfg = cfg
        ctx.save_for_backward(alpha, l_factor, sigma2, *ks)
        outs = (info["quad"], info["logdet"], info["cg_rel_residual"])
        ctx.mark_non_differentiable(*outs)
        return (nll,) + outs

    @staticmethod
    def backward(ctx, g, *_):
        op, rank, cg_iters, lanczos_iters, zs, zg = ctx.cfg
        alpha, l_factor, sigma2, *ks = ctx.saved_tensors
        with torch.no_grad():
            p_inv = it.woodbury_preconditioner(l_factor, sigma2)[0]
            z = zg.T                                                     # (n, P)
            with full_fp32():
                u = it._pcg_columns(_matvec(op, ks, sigma2), z, p_inv, 1e-6, cg_iters)
            probes = z.shape[1]
            w = torch.cat([z, alpha[:, None]], dim=1)
            c = torch.cat([u * (0.5 / probes), -0.5 * alpha[:, None]], dim=1)
            g_s2 = 0.5 * it._dot(u, z).mean() - 0.5 * torch.dot(alpha, alpha)
        needs = ctx.needs_input_grad[3:]
        leaves = [k.detach().requires_grad_(bool(nd)) for k, nd in zip(ks, needs)]
        wanted = [k for k in leaves if k.requires_grad]
        g_ks = [None] * len(leaves)
        if wanted:
            with torch.enable_grad():
                grads = iter(torch.autograd.grad(op.bilinear(leaves, c, w), wanted,
                                                 allow_unused=True))
            g_ks = [g * next(grads) if k.requires_grad else None for k in leaves]
        return (None, g * alpha if ctx.needs_input_grad[1] else None,
                g * g_s2 if ctx.needs_input_grad[2] else None, *g_ks)


def _op_nll(op, ks, sigma2, y, rank, cg_iters, probes, lanczos_iters, seed):
    sigma2 = torch.as_tensor(sigma2, dtype=y.dtype, device=y.device)
    zs, zg = it._draw_pair(seed, probes, y.shape[0], y.dtype, y.device, it.GRAD_SEED_OFFSET)
    nll, quad, logdet, rel = _OpNLL.apply((op, rank, cg_iters, lanczos_iters, zs, zg), y,
                                          sigma2, *ks)
    return nll, {"quad": quad, "logdet": logdet, "cg_rel_residual": rel}


def _op_solve(op, ks, sigma2, b, rank, cg_iters):
    """S^{-1} B for (n,) or (n, m) right-hand sides by (multi-RHS) PCG."""
    mv = _matvec(op, ks, sigma2)
    _, (p_inv, _, _) = _preconditioner(op, ks, sigma2, rank)
    if b.ndim == 1:
        return it.pcg_solve(mv, b, p_inv, maxiter=cg_iters)
    return it.pcg_solve(mv, b.T, p_inv, maxiter=cg_iters).T


# ---------------------------------------------------------------------------
# incomplete grids: the observed block of the Kronecker gram
# ---------------------------------------------------------------------------


class _Masked(_Op):
    """((x)K_i)[obs, obs]: scatter into the full grid, per-axis
    contractions, gather back; ``idx`` the D (n_obs,) multi-index columns."""

    def __init__(self, idx, shape):
        self.idx = tuple(idx)
        self.shape = tuple(int(s) for s in shape)

    def scatter(self, v):
        out = v.new_zeros(self.shape + v.shape[1:])
        out[self.idx] = v
        return out

    def kmv(self, ks, v):
        return kron_apply(list(ks), self.scatter(v))[self.idx]

    def diag(self, ks):
        out = None
        for k, ix in zip(ks, self.idx):
            d = torch.diagonal(k)[ix]
            out = d if out is None else out * d
        return out

    def column(self, ks, j):
        n = self.idx[0].shape[0]
        e = torch.zeros(n, dtype=ks[0].dtype, device=ks[0].device)
        return self.kmv(ks, e.scatter(0, j.reshape(1), 1.0))

    def bilinear(self, ks, c, w):
        return (self.scatter(c) * kron_apply(list(ks), self.scatter(w))).sum()


def masked_kron_matvec(ks, idx, shape, sigma2, v):
    """((x)K_i + s2 I)[obs, obs] @ v for v (n_obs,) or (n_obs, m)."""
    return _Masked(idx, shape).kmv(ks, v) + sigma2 * v


def masked_kron_nll(ks, sigma2, y, idx, shape, rank=64, cg_iters=100, probes=8,
                    lanczos_iters=25, seed=0):
    """Matrix-free exact NLL of ``y_obs ~ N(0, ((x)K_i + s2 I)[obs, obs])``
    on an incomplete grid: ``idx`` the (D, n_obs) multi-indices of the
    observed cells, ``shape`` the grid shape.  Differentiable in the grams,
    the noise and ``y`` through the BBMM stochastic-trace backward.
    Returns ``(nll, info)``."""
    return _op_nll(_Masked(idx, shape), ks, sigma2, y, rank, cg_iters, probes, lanczos_iters,
                   seed)


def masked_cross_solve(ks, sigma2, idx, shape, b, rank=64, cg_iters=200):
    """S_obs^{-1} B for (n_obs,) or (n_obs, m) right-hand sides by
    (multi-RHS) PCG with the pivoted-Cholesky Woodbury preconditioner."""
    return _op_solve(_Masked(idx, shape), ks, sigma2, b, rank, cg_iters)


# ---------------------------------------------------------------------------
# SKI / KISS-GP: scattered rows interpolated onto a uniform grid
# ---------------------------------------------------------------------------


def cubic_interp_axis(lo, h, m, xq):
    """Keys cubic-convolution taps on the uniform axis ``lo + h*[0..m-1]``:
    ``(idx (nq, 4) long, w (nq, 4))``, the edge taps clipped (a = -1/2; at
    a node the weights are one-hot)."""
    p = (xq - lo) / h
    i0 = torch.clamp(torch.floor(p), 0, m - 1)
    s = p - i0
    d = torch.stack([1.0 + s, s, 1.0 - s, 2.0 - s], dim=-1)
    ad = torch.abs(d)
    near = 1.5 * ad ** 3 - 2.5 * ad ** 2 + 1.0
    far = -0.5 * ad ** 3 + 2.5 * ad ** 2 - 4.0 * ad + 2.0
    w = torch.where(ad <= 1.0, near, torch.where(ad < 2.0, far, torch.zeros_like(ad)))
    base = i0.to(torch.int64)[..., None] + torch.arange(-1, 3, device=xq.device)
    return torch.clamp(base, 0, m - 1), w.to(xq.dtype)


def _ski_lin(idxs, ws, shape):
    """One (n, 4^D) table of flattened grid indices and weight products."""
    nd = len(idxs)
    strides = [1] * nd
    for i in range(nd - 2, -1, -1):
        strides[i] = strides[i + 1] * int(shape[i + 1])
    lin, wp = None, None
    for i in range(nd):
        ix = idxs[i] * strides[i]
        if lin is None:
            lin, wp = ix, ws[i]
        else:
            lin = (lin[:, :, None] + ix[:, None, :]).reshape(ix.shape[0], -1)
            wp = (wp[:, :, None] * ws[i][:, None, :]).reshape(ix.shape[0], -1)
    return lin, wp


def ski_wv(idxs, ws, grid):
    """W @ v_grid for scattered rows (``grid`` may carry trailing batch
    axes): one gather over the flattened grid."""
    nd = len(idxs)
    lin, wp = _ski_lin(idxs, ws, grid.shape[:nd])
    flat = grid.reshape((-1,) + grid.shape[nd:])
    piece = flat[lin]                                          # (n, 4^D, *batch)
    return (piece * wp.reshape(wp.shape + (1,) * (piece.ndim - 2))).sum(dim=1)


def ski_wtv(idxs, ws, v, shape):
    """W' @ v: the weighted row values scatter-added into the grid (``v``
    may carry trailing batch axes), one ``index_add_``."""
    lin, wp = _ski_lin(idxs, ws, shape)
    u = int(np.prod(shape))
    vals = v[:, None] * wp.reshape(wp.shape + (1,) * (v.ndim - 1))
    flat = v.new_zeros((u,) + v.shape[1:])
    flat.index_add_(0, lin.reshape(-1), vals.reshape((-1,) + v.shape[1:]))
    return flat.reshape(tuple(shape) + v.shape[1:])


def ski_dense_w(idxs, ws, shape):
    """Per-axis dense (n, m_i) interpolation matrices from the taps
    (duplicate clipped edge taps accumulate)."""
    n = idxs[0].shape[0]
    rows = torch.arange(n, device=idxs[0].device)[:, None].expand(idxs[0].shape)
    return [w.new_zeros((n, int(m))).index_put_((rows, ix), w, accumulate=True)
            for ix, w, m in zip(idxs, ws, shape)]


def ski_operator(idxs, ws, shape):
    """``(wv, wtv, row_grid)`` closures of the SKI interpolation operator:
    W g by gather, W' v by scatter-add, and ``row_grid(j)`` the grid tensor
    of W' e_j as a rank-1 field (j a 0-d long tensor: the pivoted Cholesky
    reads a column without a full W' pass)."""
    nd = len(shape)

    def row_grid(j):
        out = None
        for i, (ix, w) in enumerate(zip(idxs, ws)):
            axis = w.new_zeros(int(shape[i])).index_add(0, ix[j], w[j])
            sh = [1] * nd
            sh[i] = int(shape[i])
            axis = axis.reshape(sh)
            out = axis if out is None else out * axis
        return out

    return (lambda grid: ski_wv(idxs, ws, grid), lambda v: ski_wtv(idxs, ws, v, shape),
            row_grid)


def ski_prior_diag(ks, idxs, ws):
    """The exact diagonal of W K_uu W': a product over axes of w_i[r]'
    K_i[c_i[r], c_i[r]] w_i[r], O(n D 16)."""
    out = None
    with full_fp32():
        for k, ix, w in zip(ks, idxs, ws):
            blk = k[ix[:, :, None], ix[:, None, :]]                   # (n, 4, 4)
            d = torch.einsum("na,nab,nb->n", w, blk, w)
            out = d if out is None else out * d
    return out


class _SKI(_Op):
    """W K_uu W' over taps ``idx``/``w`` (D, n, 4)."""

    def __init__(self, idx, w, shape):
        self.idxs, self.ws = tuple(idx), tuple(w)
        self.shape = tuple(int(s) for s in shape)
        self.wv, self.wtv, self.row_grid = ski_operator(self.idxs, self.ws, self.shape)

    def kmv(self, ks, v):
        return self.wv(kron_apply(list(ks), self.wtv(v)))

    def diag(self, ks):
        return ski_prior_diag(ks, self.idxs, self.ws)

    def column(self, ks, j):
        return self.wv(kron_apply(list(ks), self.row_grid(j)))

    def bilinear(self, ks, c, w):
        # sum(c * W K W' w) = sum(W' c * K W' w): autograd sees only K
        return (self.wtv(c) * kron_apply(list(ks), self.wtv(w))).sum()


def ski_nll(ks, sigma2, y, idx, w, shape, rank=64, cg_iters=100, probes=8, lanczos_iters=25,
            seed=0):
    """Matrix-free NLL of ``y ~ N(0, W K_uu W' + s2 I)`` (SKI): ``idx``
    (D, n, 4) taps, ``w`` (D, n, 4) cubic weights, ``shape`` the inducing
    grid's.  Differentiable in the grams, the noise and ``y`` (the weights
    are geometry) through the BBMM backward.  Returns ``(nll, info)``."""
    return _op_nll(_SKI(idx, w, shape), ks, sigma2, y, rank, cg_iters, probes, lanczos_iters,
                   seed)


def ski_solve(ks, sigma2, idx, w, shape, b, rank=64, cg_iters=200):
    """(W K_uu W' + s2 I)^{-1} B for (n,) or (n, m) right-hand sides."""
    return _op_solve(_SKI(idx, w, shape), ks, sigma2, b, rank, cg_iters)
