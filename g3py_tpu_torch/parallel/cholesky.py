"""Row-band-sharded exact-GP linear algebra over a mesh (the PyTorch
counterpart of :mod:`g3py_tpu.parallel.cholesky`).

Each rank of a D-rank mesh axis holds the (n/D, n) row band of the n x n
gram whose rows ``[r n/D, (r+1) n/D)`` it owns; no rank ever holds the
whole matrix when D > 1, in the forward or the backward pass.  Every rank
runs the same panel loop (the JAX package's ``shard_map`` body), meeting
the others in :mod:`.mesh`'s collectives:

  for panel k (block B):
    A_kk   = psum(owner's (B, B) diagonal tile, zero elsewhere)
    L_kk, its panel inverses = K2 (panel_cholesky)   (one launch)
    Dinv   = L_kk^{-1}                               (trtri_from_panels)
    L[i,k] = A[i,k] Dinv^T   for my rows below the panel
    col_k  = all_gather(my strip of L[:,k])          (n, B)
    A[i,j] -= L[i,k] col_k[j]^T   for my rows and the columns right of
                                  the panel (the JAX body masks the rest;
                                  here the slices skip it)

and the forward/transpose substitutions solve ``L Z = B`` and
``L^T A = B`` band-wise with one psum a panel (forward, the owner's rows,
zero on the others; backward, every rank's solved share), as the JAX body
psums masked values.  The strip products and the
trailing update are ``torch.matmul`` in full FP32 (config.py's TF32-off
policy; the JAX package's ``Precision.HIGHEST``).  A failed diagonal tile
gives NaN, as ``jnp.linalg.cholesky`` does, with no host read; the
models' guards read the result once.

:func:`distributed_quad_logdet` is the trainable primitive
``fn(params, x, resid) -> (quad, logdet_half)`` — a
``torch.autograd.Function`` whose forward builds this rank's band gram
(``cov_fn(params, x_band, x)``, K1 for a stationary kernel), factors and
solves it, and whose backward forms X = L^{-1} band-wise, alpha = X^T z,
S = K^{-1} band by band (D psums, each rank keeping its own chunk), the band cotangent K_bar = gl/2 S - gq alpha_band
alpha^T and the parameter cotangent by autograd of the band gram —
summed over the ranks (each rank's vjp is its band's share; ``shard_map``
sums it implicitly in the JAX package).  ``resid`` is replicated and its
cotangent 2 gq alpha is the full vector, so autograd through the mean and
the warping gives the same gradient on every rank.
"""

import math

import numpy as np
import torch

from ..config import settings, as_tensor
from ..ops.linalg import panel_cholesky, trtri_from_panels
from .mesh import make_mesh, psum, all_gather, band_rows

__all__ = ["distributed_cholesky", "distributed_trsm", "distributed_trsm_t",
           "distributed_quad_logdet", "distributed_gp_nll", "distributed_posterior"]

LOG2PI = math.log(2.0 * math.pi)


def _resolve_mesh(mesh, axis):
    return make_mesh(axis_names=(axis,)) if mesh is None else mesh


def _check_dims(n, n_dev, block):
    if n % n_dev:
        raise ValueError(f"n={n} must divide over {n_dev} devices")
    rows = n // n_dev
    if block is None:
        # the largest divisor of the rows a rank holds, up to 256: the
        # default never breaks the multiple-of-block rule
        block = next(b for b in range(min(rows, 256), 0, -1) if rows % b == 0)
    if rows % block:
        raise ValueError("rows-per-device must be a multiple of block")
    return block


def _layout(mesh, axis, n):
    d = mesh.axis_size(axis)
    rows = n // d
    return d, rows, mesh.axis_index(axis) * rows


def _diag_tile(akk):
    """``(L_kk, L_kk^{-1})`` of a psummed (B, B) diagonal tile: K2 factors
    it and returns its 128-wide panel inverses in one launch, which seed
    the inverse.  A failed factor is NaN (no host read)."""
    lkk, dinv, info = panel_cholesky(akk)
    ok = info == 0
    lkk = torch.where(ok, lkk, torch.full_like(lkk, float("nan")))
    return lkk, torch.where(ok, trtri_from_panels(lkk, dinv),
                            torch.full_like(lkk, float("nan")))


def _band_cholesky(a, mesh, n, block, axis):
    """L's row band from the gram's row band ``a`` (rows, n)."""
    d, rows, row0 = _layout(mesh, axis, n)
    a = a.clone()
    for k in range(n // block):
        kb, ke = k * block, (k + 1) * block
        owns = row0 <= kb and ke <= row0 + rows
        tile = a[kb - row0:ke - row0, kb:ke] if owns else a.new_zeros((block, block))
        lkk, dinv = _diag_tile(psum(mesh, tile, axis))
        if owns:
            a[kb - row0:ke - row0, kb:ke] = lkk
        lo = min(max(ke - row0, 0), rows)  # my first row below the panel
        strip = torch.matmul(a[lo:, kb:ke], dinv.T)
        a[lo:, kb:ke] = strip
        if ke == n:
            break
        mine = a.new_zeros((rows, block))
        mine[lo:] = strip
        col = all_gather(mesh, mine, axis)  # (n, B); zero above the panel
        a[lo:, ke:] -= torch.matmul(strip, col[ke:].T)
    # my band of the strict upper triangle is zero
    return torch.tril(a, diagonal=row0)


def _band_trsm(l, b, mesh, n, block, axis):
    """Forward substitution ``L Z = B`` on row bands: ``b`` (rows, m)."""
    d, rows, row0 = _layout(mesh, axis, n)
    b = b.clone()
    m = b.shape[1]
    for k in range(n // block):
        kb, ke = k * block, (k + 1) * block
        owns = row0 <= kb and ke <= row0 + rows
        part = (torch.cat([l[kb - row0:ke - row0, kb:ke], b[kb - row0:ke - row0]], dim=1)
                if owns else b.new_zeros((block, block + m)))
        part = psum(mesh, part, axis)
        zk = torch.linalg.solve_triangular(part[:, :block], part[:, block:], upper=False)
        if owns:
            b[kb - row0:ke - row0] = zk
        lo = min(max(ke - row0, 0), rows)
        b[lo:] -= torch.matmul(l[lo:, kb:ke], zk)
    return b


def _band_trsm_t(l, b, mesh, n, block, axis):
    """Backward substitution ``L^T A = B`` on row bands: panels bottom-up,
    panel k subtracting the psum of ``L[i,k]^T a_i`` over the rows already
    solved (every row below the panel) before its solve against L_kk^T."""
    d, rows, row0 = _layout(mesh, axis, n)
    b = b.clone()
    m = b.shape[1]
    for k in reversed(range(n // block)):
        kb, ke = k * block, (k + 1) * block
        owns = row0 <= kb and ke <= row0 + rows
        lo = min(max(ke - row0, 0), rows)
        contrib = torch.matmul(l[lo:, kb:ke].T, b[lo:])  # my solved rows' share
        if owns:
            part = torch.cat([l[kb - row0:ke - row0, kb:ke],
                              b[kb - row0:ke - row0] - contrib], dim=1)
        else:
            part = torch.cat([b.new_zeros((block, block)), -contrib], dim=1)
        part = psum(mesh, part, axis)
        ak = torch.linalg.solve_triangular(part[:, :block].T, part[:, block:], upper=True)
        if owns:
            b[kb - row0:ke - row0] = ak
    return b


def _as_band(mesh, a, n, axis):
    """``a`` as this rank's row band: a whole (n, ...) array is cut, a band
    ((n/D, ...) rows) is taken as it is."""
    a = as_tensor(a)
    return band_rows(mesh, a, axis) if a.shape[0] == n and mesh.axis_size(axis) > 1 else a


def distributed_cholesky(a, mesh=None, block=None, axis="dp"):
    """Cholesky of a row-band-sharded SPD matrix over the mesh: ``a`` is
    the whole (n, n) matrix or this rank's (n/D, n) band; the rows a rank
    holds must be a multiple of ``block``.  Returns this rank's band of L
    (:func:`~g3py_tpu_torch.parallel.mesh.gather_rows` gives the whole)."""
    mesh = _resolve_mesh(mesh, axis)
    n = a.shape[-1]
    block = _check_dims(n, mesh.axis_size(axis), block)
    return _band_cholesky(_as_band(mesh, a, n, axis), mesh, n, block, axis)


def distributed_trsm(l, b, mesh=None, block=None, axis="dp"):
    """Solve ``L Z = B`` with L row-band-sharded (as from
    :func:`distributed_cholesky`); B (n,) or (n, m), whole or this rank's
    band.  Returns this rank's band of Z."""
    return _solve(_band_trsm, l, b, _resolve_mesh(mesh, axis), block, axis)


def distributed_trsm_t(l, b, mesh=None, block=None, axis="dp"):
    """Solve ``L^T A = B`` on the same layout as :func:`distributed_trsm`."""
    return _solve(_band_trsm_t, l, b, _resolve_mesh(mesh, axis), block, axis)


def _solve(band_solve, l, b, mesh, block, axis):
    n = l.shape[-1]
    block = _check_dims(n, mesh.axis_size(axis), block)
    b = _as_band(mesh, b, n, axis)
    squeeze = b.ndim == 1
    z = band_solve(as_tensor(l), b[:, None] if squeeze else b, mesh, n, block, axis)
    return z[:, 0] if squeeze else z


def _band_gram_fn(cov_fn, noise_fn, mesh, axis):
    """``fn(params, x) -> (n/D, n)``: this rank's rows of the gram plus the
    noise on its global diagonal."""

    def fn(params, x):
        n = x.shape[0]
        _, rows, row0 = _layout(mesh, axis, n)
        g = cov_fn(params, x[row0:row0 + rows], x)
        if noise_fn is not None:
            idx = torch.arange(rows, device=g.device)
            g = g.index_put((idx, idx + row0), g[idx, idx + row0] + noise_fn(params))
        return g

    return fn


class _QuadLogdet(torch.autograd.Function):
    """(quad, logdet_half) of the band-sharded gram; see the module
    docstring for the backward."""

    @staticmethod
    def forward(ctx, prim, x, resid, keys, *values):
        params = dict(zip(keys, values))
        mesh, axis, n = prim.mesh, prim.axis, resid.shape[0]
        _, rows, row0 = _layout(mesh, axis, n)
        with torch.no_grad():
            a = prim.band_gram(params, x)
            l = _band_cholesky(a, mesh, n, prim.block_for(n), axis)
            del a
            z = _band_trsm(l, resid[row0:row0 + rows, None], mesh, n, prim.block_for(n),
                           axis)[:, 0]
            idx = torch.arange(rows, device=l.device)
            quad = psum(mesh, torch.dot(z, z), axis)
            logdet_half = psum(mesh, torch.log(l[idx, idx + row0]).sum(), axis)
        ctx.prim, ctx.keys = prim, keys
        ctx.save_for_backward(x, l, z, *values)
        return quad, logdet_half

    @staticmethod
    def backward(ctx, gq, gl):
        prim, keys = ctx.prim, ctx.keys
        x, l, z, *values = ctx.saved_tensors
        mesh, axis, n = prim.mesh, prim.axis, l.shape[1]
        d, rows, row0 = _layout(mesh, axis, n)
        block = prim.block_for(n)
        with torch.no_grad():
            eye = torch.zeros((rows, n), dtype=l.dtype, device=l.device)
            idx = torch.arange(rows, device=l.device)
            eye[idx, idx + row0] = 1.0
            xinv = _band_trsm(l, eye, mesh, n, block, axis)  # my rows of L^{-1}
            del eye
            alpha = psum(mesh, torch.matmul(xinv.T, z), axis)  # K^{-1} resid
            # my rows of S = K^{-1} = X^T X: chunk c is the psum of every
            # rank's X[:, c]^T X, kept by rank c
            s = None
            for c in range(d):
                part = psum(mesh, torch.matmul(xinv[:, c * rows:(c + 1) * rows].T, xinv), axis)
                if c == mesh.axis_index(axis):
                    s = part
                del part
            del xinv
            alpha_band = alpha[row0:row0 + rows]
            kbar = (0.5 * gl) * s - gq * alpha_band[:, None] * alpha[None, :]
            del s
        need = [i for i, v in enumerate(values) if ctx.needs_input_grad[4 + i]]
        grads = [None] * len(values)
        if need:
            with torch.enable_grad():
                leaves = [v.detach().requires_grad_(True) for v in values]
                params = dict(zip(keys, leaves))
                g = prim.band_gram(params, x)
                got = torch.autograd.grad(g, [leaves[i] for i in need], grad_outputs=kbar,
                                          allow_unused=True)
            # each rank's vjp is its band's share of the cotangent
            flat = torch.cat([(t if t is not None else torch.zeros_like(values[i])).reshape(-1)
                              for i, t in zip(need, got)])
            flat = psum(mesh, flat, axis)
            off = 0
            for i in need:
                size = values[i].numel()
                grads[i] = flat[off:off + size].reshape(values[i].shape)
                off += size
        gresid = (2.0 * gq) * alpha if ctx.needs_input_grad[2] else None
        return (None, None, gresid, None, *grads)


class _Primitive:
    def __init__(self, cov_fn, noise_fn, mesh, block, axis):
        self.mesh, self.axis, self.block = mesh, axis, block
        self.band_gram = _band_gram_fn(cov_fn, noise_fn, mesh, axis)

    def block_for(self, n):
        return _check_dims(n, self.mesh.axis_size(self.axis), self.block)


def distributed_quad_logdet(cov_fn, mesh=None, block=None, axis="dp", noise_fn=None):
    """The trainable band-sharded elliptical primitive ``fn(params, x, y) ->
    (quad, logdet_half)``: ``quad = y' K^{-1} y`` and ``logdet_half = sum
    log diag chol(K)`` (= 1/2 log det K), K = ``cov_fn(params, x, x)`` plus
    ``noise_fn(params)`` on the diagonal — the sharded counterpart of
    ``ops.linalg.mvn_quad_logdet``.  ``x`` (n, d) and ``y`` (n,) are whole
    on every rank; differentiable in the params' tensors and ``y`` (``x``
    is constant).  Every rank calls it with the same arguments and gets
    the same values."""
    mesh = _resolve_mesh(mesh, axis)
    prim = _Primitive(cov_fn, noise_fn, mesh, block, axis)

    def fn(params, x, y):
        keys = tuple(params)
        x, y = as_tensor(x), as_tensor(y)
        prim.block_for(y.shape[0])  # the layout's errors before any collective
        return _QuadLogdet.apply(prim, x, y, keys, *[as_tensor(params[k]) for k in keys])

    fn.mesh = mesh
    return fn


def distributed_gp_nll(cov_fn, mesh=None, block=None, axis="dp", noise_fn=None):
    """The trainable band-sharded exact-GP negative log likelihood
    ``nll(params, x, y)``: the gaussian scalarization of
    :func:`distributed_quad_logdet` (same arguments and layout)."""
    qld = distributed_quad_logdet(cov_fn, mesh=mesh, block=block, axis=axis,
                                  noise_fn=noise_fn)

    def nll(params, x, y):
        quad, logdet_half = qld(params, x, y)
        n = len(y)
        return 0.5 * quad + logdet_half + 0.5 * n * float(np.float32(LOG2PI))

    return nll


def distributed_posterior(cov_fn, mesh=None, block=None, axis="dp", noise_fn=None):
    """Band-sharded gaussian-posterior serving: ``(state_fn, query_fn,
    solve_fn, apply_fn)``.

      state_fn(params, x, resid) -> (l_band, alpha_band)
        one band Cholesky of the noisy gram and two band solves,
        alpha = (K + s^2 I)^{-1} resid (forward, then transpose).
      query_fn(params, x, l_band, alpha_band, xq) -> (mean_delta, var_red)
        this rank's (n/D, m) cross band contributes ``cross^T alpha`` to
        the mean and ``colsum((L^{-1} K_Xq)_band^2)`` to the variance
        reduction, each psummed.
      solve_fn(l_band, b) -> (K + s^2 I)^{-1} B, this rank's band (exact:
        two band solves).
      apply_fn(params, x, xq, a_band) -> K_qX A (psummed; the (m, n) cross
        matrix never exists whole).

    The caller assembles ``mu = m(xq) + mean_delta`` and ``var = k_ss -
    var_red`` (:class:`~g3py_tpu_torch.models.predictor.
    DistributedPredictor`)."""
    mesh = _resolve_mesh(mesh, axis)
    band_gram = _band_gram_fn(cov_fn, noise_fn, mesh, axis)

    def block_for(n):
        return _check_dims(n, mesh.axis_size(axis), block)

    @torch.no_grad()
    def state_fn(params, x, resid):
        x, resid = as_tensor(x), as_tensor(resid)
        n = resid.shape[0]
        blk = block_for(n)
        _, rows, row0 = _layout(mesh, axis, n)
        l = _band_cholesky(band_gram(params, x), mesh, n, blk, axis)
        z = _band_trsm(l, resid[row0:row0 + rows, None], mesh, n, blk, axis)
        return l, _band_trsm_t(l, z, mesh, n, blk, axis)[:, 0]

    @torch.no_grad()
    def query_fn(params, x, l_band, alpha_band, xq):
        x, xq = as_tensor(x), as_tensor(xq)
        n = l_band.shape[1]
        _, rows, row0 = _layout(mesh, axis, n)
        cross = cov_fn(params, x[row0:row0 + rows], xq)  # (rows, m)
        mean_delta = psum(mesh, torch.matmul(cross.T, alpha_band), axis)
        w = _band_trsm(l_band, cross, mesh, n, block_for(n), axis)
        return mean_delta, psum(mesh, (w * w).sum(dim=0), axis)

    @torch.no_grad()
    def solve_fn(l_band, b):
        n = l_band.shape[1]
        b = _as_band(mesh, b, n, axis)
        blk = block_for(n)
        return _band_trsm_t(l_band, _band_trsm(l_band, b, mesh, n, blk, axis), mesh, n, blk,
                            axis)

    @torch.no_grad()
    def apply_fn(params, x, xq, a):
        x, xq = as_tensor(x), as_tensor(xq)
        n = x.shape[0]
        _, rows, row0 = _layout(mesh, axis, n)
        a = _as_band(mesh, a, n, axis)
        return psum(mesh, torch.matmul(cov_fn(params, xq, x[row0:row0 + rows]), a), axis)

    return state_fn, query_fn, solve_fn, apply_fn
