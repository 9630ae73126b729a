"""Matrix-free (iterative) GP inference: CG solves and stochastic Lanczos
log-determinants (the PyTorch counterpart of :mod:`g3py_tpu.ops.iterative`).

Following the BBMM line of work (GPyTorch, arXiv:1809.11165; preconditioned
scalable GP hyperparameter optimization, arXiv:2107.00243):

* :func:`cg_solve` / :func:`pcg_solve` — conjugate gradients against any
  matvec.  Several right-hand sides go through ONE matvec an iteration as
  the columns of a matrix: a lazy-gram matvec then builds each gram slab
  once for all of them.
* :func:`slq_logdet` — stochastic Lanczos quadrature, every probe a column
  of one batched Lanczos recursion, the tridiagonals through one batched
  ``eigh``.
* :func:`pivoted_cholesky` / :func:`woodbury_preconditioner` — the rank-r
  preconditioner P = sigma^2 I + L L^T.
* :func:`lazy_kernel_matvec` — K @ v without materializing K: the gram is
  built one (block, n) row slab at a time (O(block n) memory), through the
  kernel's own ``cov`` (the fused stationary-gram kernel on the card).
* :func:`preconditioned_gp_nll` and :func:`iterative_gp_nll` — the assembled
  marginal likelihood as ``torch.autograd.Function``s whose backward is the
  Hutchinson stochastic-trace estimator.

The JAX package runs its loops as device ``while_loop``/``scan``.  Here the
loops run on the host and every step stays on the device: a CG column whose
test fails is left as it was (a vmapped ``while_loop``'s frozen lane), and
the host reads the flags once every ``CHECK_EVERY`` iterations, so the
iterations past convergence change nothing.  ``counts`` tallies the host
reads and the lazy-gram passes (``matvecs``: one slab pass each;
``grad_passes``: the backward's differentiated slab pass; ``columns``: the
pivoted Cholesky's (n, 1) grams; ``diag_blocks``: the (block, block) grams
the diagonal is read from), from which a run predicts its gram launches.

Every float32 product of this path is full FP32 (JAX's
``Precision.HIGHEST``): TF32 stalls CG.  The entry points set
``torch.set_float32_matmul_precision('highest')`` for their duration and
restore the caller's setting after.

The draws (``key`` / ``seed``) are an int (a ``torch.Generator`` seeded with
it), a ``torch.Generator``, or the draws themselves (see each function), so
that the same probes give the same numbers on any platform.  The streams are
kept apart as in the JAX package: the SLQ probes come from ``seed``, the
gradient's probes of :func:`preconditioned_gp_nll` from ``seed + 104729``,
those of :func:`iterative_gp_nll` from the SLQ generator, drawn after its
probes.
"""

import contextlib

import numpy as np
import torch

__all__ = ["cg_solve", "slq_logdet", "lazy_kernel_matvec", "iterative_gp_nll",
           "pivoted_cholesky", "woodbury_preconditioner", "pcg_solve",
           "preconditioned_gp_nll"]

#: iterations between two host reads of the CG flags
CHECK_EVERY = 4
#: host reads and lazy-gram passes since the last :func:`reset_counts`
counts = {"reads": 0, "matvecs": 0, "grad_passes": 0, "columns": 0, "diag_blocks": 0}
#: the SLQ and gradient probe streams of a seed (JAX: PRNGKey(seed), PRNGKey(seed + 104729))
GRAD_SEED_OFFSET = 104729


def reset_counts():
    for k in counts:
        counts[k] = 0


@contextlib.contextmanager
def full_fp32():
    """Full-FP32 matrix products for the duration (TF32 off), whatever the
    caller's ``torch.set_float32_matmul_precision``."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _dot(a, b):
    """Per-column dot products: a scalar for vectors, (k,) for (n, k)."""
    return (a * b).sum(dim=0)


def _generator(key, device):
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def _rademacher(gen, shape, dtype, device):
    return (2 * torch.randint(0, 2, shape, generator=gen, device=device) - 1).to(dtype)


def _as_draws(z, dtype, device):
    return torch.as_tensor(z if isinstance(z, torch.Tensor) else np.array(z),
                           dtype=dtype, device=device)


def _host_loop(active_fn, step, state, maxiter):
    """``state = step(state, active)`` up to ``maxiter`` times, where
    ``active = active_fn(state)`` masks which columns (or, as a scalar, the
    whole state) step; the host reads ``active.any()`` every
    ``CHECK_EVERY`` iterations and stops at the first read with none."""
    for it in range(maxiter):
        active = active_fn(state)
        if it % CHECK_EVERY == 0:
            counts["reads"] += 1
            if not bool(active.any()):
                break
        state = step(state, active)
    return state


def _ratio(num, den, ok):
    """``num / den`` where ``ok``, else 0 (the division never sees a
    non-positive ``den``)."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(den))


def _pcg_columns(matvec, b, p_inv, tol, maxiter, x0=None, relative=True):
    """Preconditioned CG on ``b`` ((n,) or (n, k) columns), each column its
    own scalars and its own stopping test (|r|^2 > tol^2 |b|^2, or with
    ``relative`` False |r|^2 > tol^2), a stopped column frozen: the JAX
    package's single-vector ``pcg_solve`` loop (with ``p_inv`` the
    identity, ``cg_solve``'s), vmapped over columns."""
    x = torch.zeros_like(b) if x0 is None else x0.expand_as(b).clone()
    r = b if x0 is None else b - matvec(x)  # b - K 0 = b: no matvec for the zero start
    z = p_inv(r)
    bound = tol ** 2 * (_dot(b, b) if relative else 1.0)
    state = (x, r, z, _dot(r, z))

    def active_fn(s):
        rr = _dot(s[1], s[1])
        return torch.isfinite(rr) & (rr > bound)

    def step(s, act):
        x_, r_, p_, rz_ = s
        ap = matvec(p_)
        pap = _dot(p_, ap)
        # f32 roundoff near convergence can drive p'Ap (or r'z) slightly
        # negative on a PSD operator: treat it as breakdown, no step (and a
        # steepest-descent restart)
        ok = (pap > 1e-30) & (rz_ > 1e-30)
        alpha = _ratio(rz_, pap, ok)
        x_n = x_ + alpha * p_
        r_n = r_ - alpha * ap
        z_n = p_inv(r_n)
        rz_n = _dot(r_n, z_n)
        p_n = z_n + _ratio(rz_n, rz_, ok) * p_
        return tuple(torch.where(act, new, old) for new, old in zip((x_n, r_n, p_n, rz_n), s))

    return _host_loop(active_fn, step, state, maxiter)[0]


def cg_solve(matvec, b, tol=1e-6, maxiter=100, x0=None):
    """Conjugate gradients for PSD systems; ``b`` may be (n,) or (k, n)
    (k right-hand sides, each with its own scalars and stopping test, all
    through one ``matvec`` of the (n, k) columns an iteration).
    ``matvec`` maps (n,) to (n,) and (n, k) to (n, k)."""
    with full_fp32():
        if b.ndim == 2:
            return _pcg_columns(matvec, b.T, _identity, tol, maxiter,
                                None if x0 is None else x0[:, None], relative=False).T
        return _pcg_columns(matvec, b, _identity, tol, maxiter, x0, relative=False)


def _identity(r):
    return r


def _pcg_solve_mrhs(matvec, b, p_inv, tol, maxiter):
    """Multi-RHS PCG on (m, n) right-hand sides: per-column alpha/beta, one
    shared matvec an iteration, every column stepping (a column's breakdown
    guard aside) until none is active — then the whole state is frozen."""
    bt = b.T  # (n, m)
    z = p_inv(bt)
    bnorm2 = _dot(bt, bt)
    state = (torch.zeros_like(bt), bt, z, _dot(bt, z))

    def active_fn(s):
        rr = _dot(s[1], s[1])
        return (torch.isfinite(rr) & (rr > tol ** 2 * bnorm2)).any()

    def step(s, running):
        x_, r_, p_, rz_ = s
        ap = matvec(p_)
        pap = _dot(p_, ap)
        ok = (pap > 1e-30) & (rz_ > 1e-30)
        alpha = _ratio(rz_, pap, ok)
        x_n = x_ + alpha * p_
        r_n = r_ - alpha * ap
        z_n = p_inv(r_n)
        rz_n = _dot(r_n, z_n)
        p_n = torch.where(ok, z_n + _ratio(rz_n, rz_, ok) * p_, p_)
        rz_n = torch.where(ok, rz_n, rz_)
        return tuple(torch.where(running, new, old)
                     for new, old in zip((x_n, r_n, p_n, rz_n), s))

    return _host_loop(active_fn, step, state, maxiter)[0].T


def pcg_solve(matvec, b, p_inv, tol=1e-6, maxiter=100):
    """Preconditioned CG: solves K x = b with the preconditioner application
    ``p_inv``.  A 2-D ``b`` (m, n) runs all right-hand sides through ONE
    shared ``matvec`` an iteration (per-column alpha/beta, every column
    stepping until none is active): a lazy-gram operator then builds each
    slab once an iteration instead of once a right-hand side."""
    with full_fp32():
        if b.ndim == 2:
            return _pcg_solve_mrhs(matvec, b, p_inv, tol, maxiter)
        return _pcg_columns(matvec, b, p_inv, tol, maxiter)


def _lanczos(matvec, z, m):
    """m-step Lanczos from ``z`` ((n,), or (n, k): k recursions as the
    columns of one matvec): ``(alphas (m,), betas (m-1,), |z|)``, or with
    columns ``((k, m), (k, m-1), (k,))``."""
    single = z.ndim == 1
    zc = z[:, None] if single else z
    znorm = torch.linalg.vector_norm(zc, dim=0)
    q = zc / torch.clamp(znorm, min=1e-30)
    k = zc.shape[1]
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(k, dtype=z.dtype, device=z.device)
    alive = torch.ones(k, dtype=torch.bool, device=z.device)
    alphas, betas = [], []
    for _ in range(m):
        w = matvec(q) - beta_prev * q_prev
        alpha = _dot(w, q)
        w = w - alpha * q
        # one-step orthogonalization (standard SLQ)
        beta = torch.linalg.vector_norm(w, dim=0)
        # Krylov breakdown: once beta underflows (relative to the scale),
        # pad the dead steps with the identity (alpha 1, beta 0: eigenvalue
        # 1, log 0) instead of spurious ~0 eigenvalues
        new_alive = alive & (beta > 1e-5 * (alpha.abs() + beta_prev + 1e-30))
        q_next = torch.where(new_alive, w / torch.clamp(beta, min=1e-30), torch.zeros_like(w))
        alphas.append(torch.where(alive, alpha, torch.ones_like(alpha)))
        beta_out = torch.where(new_alive, beta, torch.zeros_like(beta))
        betas.append(beta_out)
        q_prev, q, beta_prev, alive = q, q_next, beta_out, new_alive
    alphas = torch.stack(alphas, dim=1)
    betas = torch.stack(betas, dim=1)[:, :-1]
    if single:
        return alphas[0], betas[0], znorm[0]
    return alphas, betas, znorm


def _slq_chunk(matvec, zs, lanczos_iters):
    """SLQ terms |z|^2 sum_j w_j log(theta_j) of the probes ``zs`` (p, n)."""
    alphas, betas, znorm = _lanczos(matvec, zs.T, lanczos_iters)
    t = torch.diag_embed(alphas) + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
    theta, vecs = torch.linalg.eigh(t)
    w = vecs[:, 0, :] ** 2
    theta = torch.clamp(theta, min=1e-30)
    return znorm ** 2 * (w * torch.log(theta)).sum(dim=-1)


def slq_logdet(matvec, n, key, probes=16, lanczos_iters=30, probe_chunk=None):
    """Stochastic Lanczos quadrature estimate of log det of a PSD matvec:

        logdet ~ mean_z |z|^2 sum_j w_j log(theta_j)

    with (theta, w) the eigenpairs of each probe's Lanczos tridiagonal (w_j
    = first component^2).  ``key`` is an int, a ``torch.Generator`` (the
    (probes, n) Rademacher probes are drawn from it) or the probes
    themselves.  ``probe_chunk`` bounds how many probes share one batched
    recursion (peak memory against wall time)."""
    from ..config import settings

    with full_fp32():
        if isinstance(key, torch.Tensor):
            zs = key
        elif isinstance(key, (int, np.integer, torch.Generator)):
            device = key.device if isinstance(key, torch.Generator) else settings.device
            zs = _rademacher(_generator(key, device), (probes, n), settings.dtype, device)
        else:
            zs = _as_draws(key, settings.dtype, settings.device)
        size = zs.shape[0] if probe_chunk is None else int(probe_chunk)
        vals = torch.cat([_slq_chunk(matvec, zs[lo:lo + size], lanczos_iters)
                          for lo in range(0, zs.shape[0], size)])
    return vals.mean()


def pivoted_cholesky(column_fn, diag0, rank):
    """Rank-``rank`` pivoted (partial) Cholesky of a PSD matrix read one
    column at a time (arXiv:2107.00243; the GPyTorch preconditioner).

    ``column_fn(j) -> K[:, j]`` takes the pivot as a 0-d long tensor (no
    host read) and may build the column lazily; ``diag0`` is diag(K).
    Returns L (n, rank) with K ~ L L^T, the residual diagonal diag0 -
    sum_m L[:, m]^2 >= 0.  Once the residual diagonal underflows relative
    to the matrix scale (1e-10 of its largest entry) the remaining columns
    are zero instead of a ~1/sqrt(underflow) blow-up."""
    with full_fp32():
        n = diag0.shape[0]
        dmax0 = torch.clamp(diag0.max(), min=1e-30)
        d = diag0
        cols = torch.zeros((n, rank), dtype=diag0.dtype, device=diag0.device)
        for i in range(rank):
            j = torch.argmax(d)
            kj = column_fn(j)
            lj = torch.matmul(cols, cols[j])
            dj = d[j]
            pivot = torch.sqrt(torch.clamp(dj, min=1e-30))
            li = torch.where(dj > 1e-10 * dmax0, (kj - lj) / pivot, torch.zeros_like(kj))
            d = torch.clamp(d - li ** 2, min=0.0)
            cols[:, i] = li
    return cols


def woodbury_preconditioner(l_factor, sigma2):
    """Apply-and-logdet machinery for P = sigma2 I + L L^T (L tall-skinny).

    Returns ``(p_inv, p_inv_sqrt, logdet_p)``: the inverse and inverse square
    root as matvec closures (of (n,) or (n, k)), through the thin SVD of L
    from the r x r eigendecomposition of L^T L, and log det P."""
    with full_fp32():
        n, r = l_factor.shape
        sigma2 = torch.as_tensor(sigma2, dtype=l_factor.dtype, device=l_factor.device)
        s2, v = torch.linalg.eigh(torch.matmul(l_factor.T, l_factor))  # L^T L = V s2 V^T
        s2 = torch.clamp(s2, min=0.0)
        inv_s = torch.rsqrt(torch.clamp(s2, min=1e-30))
        u = torch.matmul(l_factor, v * inv_s[None, :])  # (n, r), orthonormal-ish
        lam = sigma2 + s2                               # the eigenvalues of P along u
        logdet_p = torch.log(lam).sum() + (n - r) * torch.log(sigma2)
    coef_inv = 1.0 / lam - 1.0 / sigma2
    coef_sqrt = torch.rsqrt(lam) - torch.rsqrt(sigma2)

    def _bcast(coef, c):
        return c * coef.reshape((-1,) + (1,) * (c.ndim - 1))

    def p_inv(w):
        with full_fp32():
            c = torch.matmul(u.T, w)
            return w / sigma2 + torch.matmul(u, _bcast(coef_inv, c))

    def p_inv_sqrt(w):
        with full_fp32():
            c = torch.matmul(u.T, w)
            return w * torch.rsqrt(sigma2) + torch.matmul(u, _bcast(coef_sqrt, c))

    return p_inv, p_inv_sqrt, logdet_p


def lazy_kernel_matvec(kernel, params, x, v, block=2048):
    """K(params, x) @ v ((n,) or (n, k)) without materializing the n x n
    gram: one (block, n) row slab at a time through ``kernel.cov``, the last
    one ragged.  O(block n) peak memory."""
    counts["matvecs"] += 1
    n = x.shape[0]
    with full_fp32():
        out = [torch.matmul(kernel.cov(params, x[lo:lo + block], x), v)
               for lo in range(0, n, block)]
    return torch.cat(out)


def _kernel_diag(kernel, params, x, block):
    """diag K(params, x) from ceil(n / block) square (block, block) grams —
    the diagonal of a single point's gram, read blockwise."""
    out = []
    for lo in range(0, x.shape[0], block):
        counts["diag_blocks"] += 1
        out.append(torch.diagonal(kernel.cov(params, x[lo:lo + block])))
    return torch.cat(out)


def _kernel_column(kernel, params, x):
    """``column_fn(j) -> K[:, j]`` of the lazy gram: one (n, 1) gram."""

    def column_fn(j):
        counts["columns"] += 1
        return kernel.cov(params, x, x.index_select(0, j.reshape(1)))[:, 0]

    return column_fn


def _log2pi_term(n):
    """0.5 n log(2 pi) with log(2 pi) rounded to float32, as the JAX
    package writes it."""
    return float(0.5 * n * np.float32(np.log(2 * np.pi)))


def _draw_pair(seed, probes, n, dtype, device, second_offset):
    """The (probes, n) SLQ probes and the gradient's probes of ``seed``: an
    int (generators seeded with ``seed`` and ``seed + second_offset``, or
    with ``second_offset`` None the first generator continued), a
    ``torch.Generator`` (both drawn from it in turn) or a dict of the draws
    (``slq``, ``grad``)."""
    if isinstance(seed, dict):
        return _as_draws(seed["slq"], dtype, device), _as_draws(seed["grad"], dtype, device)
    gen = _generator(seed, device)
    zs = _rademacher(gen, (probes, n), dtype, device)
    if isinstance(seed, torch.Generator) or second_offset is None:
        return zs, _rademacher(gen, (probes, n), dtype, device)
    return zs, _rademacher(_generator(int(seed) + second_offset, device), (probes, n),
                           dtype, device)


def _pcg_pieces(kernel, params, x, y, noise_var, mean, rank, block, cg_iters, lanczos_iters,
                zs):
    """The forward of :func:`preconditioned_gp_nll`: ``(nll, info, alpha,
    l_factor)``, no graph."""
    n = x.shape[0]
    resid = y if mean is None else y - mean

    def mv(v):
        return lazy_kernel_matvec(kernel, params, x, v, block=block) + noise_var * v

    # the preconditioner models the noise through its sigma^2 term: the
    # pivoted Cholesky reads the noise-free kernel's columns
    diag_f = _kernel_diag(kernel, params, x, block)
    l_factor = pivoted_cholesky(_kernel_column(kernel, params, x), diag_f, rank)
    p_inv, p_inv_sqrt, logdet_p = woodbury_preconditioner(l_factor, noise_var)
    alpha = pcg_solve(mv, resid, p_inv, maxiter=cg_iters)
    quad = torch.dot(resid, alpha)

    def precond_op(v):
        return p_inv_sqrt(mv(p_inv_sqrt(v)))

    logdet = logdet_p + slq_logdet(precond_op, n, zs, lanczos_iters=lanczos_iters)
    nll = 0.5 * quad + 0.5 * logdet + _log2pi_term(n)
    with full_fp32():
        rel = torch.linalg.vector_norm(mv(alpha) - resid) / torch.clamp(
            torch.linalg.vector_norm(resid), min=1e-30)
    return nll, {"quad": quad, "logdet": logdet, "cg_rel_residual": rel}, alpha, l_factor


def _trace_grads(kernel, names, leaves, x, w, c, block):
    """d/dtheta of sum(c * (K_f(theta) w)) for the params ``leaves``, one
    (block, n) slab at a time: each slab is built with a graph, contracted
    with every column of ``w`` at once, differentiated into the leaves and
    freed — O(block n) peak memory, never the n x n gram."""
    params = dict(zip(names, leaves))
    wanted = [t for t in leaves if t.requires_grad]
    if not wanted:
        return [None] * len(leaves)
    counts["grad_passes"] += 1
    total = [None] * len(wanted)
    for lo in range(0, x.shape[0], block):
        with torch.enable_grad(), full_fp32():
            slab = kernel.cov(params, x[lo:lo + block], x)
            if not slab.requires_grad:  # no kernel hyper among the leaves
                break
            s = (c[lo:lo + block] * torch.matmul(slab, w)).sum()
            grads = torch.autograd.grad(s, wanted, allow_unused=True)
        total = [g if t is None else (t if g is None else t + g) for t, g in zip(total, grads)]
    grads = iter(total)
    return [next(grads) if t.requires_grad else None for t in leaves]


class _PCGNLL(torch.autograd.Function):
    """The preconditioned NLL with the stochastic-trace backward (GPyTorch
    BBMM):

        dNLL/dth = 1/2 tr(K^{-1} dK/dth) - 1/2 a' (dK/dth) a,   a = K^{-1} r
        tr(K^{-1} dK) ~ mean_i (K^{-1} z_i)' dK z_i,   z_i Rademacher

    the probe solves K^{-1} z_i by PCG (each probe a column with its own
    scalars, frozen once it stops), the directional derivatives by autograd
    through the lazy gram one slab at a time.  The ``info`` outputs take no
    gradient."""

    @staticmethod
    def forward(ctx, cfg, y, noise_var, mean, *pvals):
        kernel, x, names, rank, block, cg_iters, lanczos_iters, zs, zg = cfg
        params = dict(zip(names, pvals))
        with torch.no_grad():
            nll, info, alpha, l_factor = _pcg_pieces(
                kernel, params, x, y, noise_var, mean, rank, block, cg_iters, lanczos_iters, zs)
        ctx.cfg = cfg
        ctx.has_mean = mean is not None
        ctx.save_for_backward(alpha, l_factor, noise_var, *pvals)
        outs = (info["quad"], info["logdet"], info["cg_rel_residual"])
        ctx.mark_non_differentiable(*outs)
        return (nll,) + outs

    @staticmethod
    def backward(ctx, g, *_):
        kernel, x, names, rank, block, cg_iters, lanczos_iters, zs, zg = ctx.cfg
        alpha, l_factor, noise_var, *pvals = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.no_grad():
            params = dict(zip(names, pvals))
            p_inv, _, _ = woodbury_preconditioner(l_factor, noise_var)

            def mv(v):
                return lazy_kernel_matvec(kernel, params, x, v, block=block) + noise_var * v

            z = zg.T                                                   # (n, P)
            with full_fp32():
                u = _pcg_columns(mv, z, p_inv, 1e-6, cg_iters)
            probes = z.shape[1]
            w = torch.cat([z, alpha[:, None]], dim=1)
            c = torch.cat([u * (0.5 / probes), -0.5 * alpha[:, None]], dim=1)
            dnv = 0.5 * _dot(u, z).mean() - 0.5 * torch.dot(alpha, alpha)
        leaves = [p.detach().requires_grad_(bool(need)) for p, need in zip(pvals, needs[4:])]
        dps = _trace_grads(kernel, names, leaves, x, w, c, block)
        ybar = g * alpha if needs[1] else None
        nvbar = g * dnv if needs[2] else None
        mbar = -g * alpha if ctx.has_mean and needs[3] else None
        return (None, ybar, nvbar, mbar, *(None if d is None else g * d for d in dps))


def preconditioned_gp_nll(kernel, params, x, y, noise_var, rank=64, block=2048, cg_iters=100,
                          probes=8, lanczos_iters=25, seed=0, mean=None):
    """Matrix-free GP NLL with the pivoted-Cholesky preconditioner
    (GPyTorch BBMM + arXiv:2107.00243):

    * K = K_f + noise_var I read lazily (one row slab, or one column, at a
      time; the n x n gram never exists);
    * P = noise_var I + L_r L_r^T from the rank-``rank`` pivoted Cholesky of
      K_f;
    * the quadratic form by preconditioned CG;
    * log det K = log det P + the SLQ log det of P^{-1/2} K P^{-1/2}.

    Differentiable with respect to ``params`` (a dict of tensors), ``y``,
    ``noise_var`` and ``mean`` through the stochastic-trace backward;
    ``x`` is a constant.  ``seed`` is an int, a ``torch.Generator`` or a
    dict of the (probes, n) draws ``slq`` and ``grad``.  Returns ``(nll,
    info)`` with the diagnostics ``quad``, ``logdet`` and
    ``cg_rel_residual`` in ``info``."""
    names = list(params)
    pvals = [torch.as_tensor(params[k], dtype=x.dtype, device=x.device) for k in names]
    noise_var = torch.as_tensor(noise_var, dtype=x.dtype, device=x.device)
    zs, zg = _draw_pair(seed, probes, x.shape[0], x.dtype, x.device, GRAD_SEED_OFFSET)
    cfg = (kernel, x, names, rank, block, cg_iters, lanczos_iters, zs, zg)
    nll, quad, logdet, rel = _PCGNLL.apply(cfg, y, noise_var, mean, *pvals)
    return nll, {"quad": quad, "logdet": logdet, "cg_rel_residual": rel}


class _QuadLogdetIter(torch.autograd.Function):
    """(r' K^{-1} r, 1/2 log det K) of a dense K by CG and SLQ, with the
    Hutchinson backward: E[K^{-1} z z^T] = K^{-1}, symmetrized."""

    @staticmethod
    def forward(ctx, k, resid, cfg):
        cg_iters, lanczos_iters, zs, zg = cfg
        with torch.no_grad(), full_fp32():
            def mv(v):
                return torch.matmul(k, v)

            alpha = cg_solve(mv, resid, maxiter=cg_iters)
            quad = torch.dot(resid, alpha)
            logdet_half = 0.5 * slq_logdet(mv, k.shape[-1], zs, lanczos_iters=lanczos_iters)
            zhat = cg_solve(mv, zg, maxiter=cg_iters)
        ctx.save_for_backward(alpha, zg, zhat)
        return quad, logdet_half

    @staticmethod
    def backward(ctx, g_quad, g_logdet):
        alpha, zs, zhat = ctx.saved_tensors
        kinv = torch.matmul(zhat.T, zs) / zs.shape[0]
        kinv = 0.5 * (kinv + kinv.T)
        dk = -g_quad * torch.outer(alpha, alpha) + (0.5 * g_logdet) * kinv
        return dk, 2.0 * g_quad * alpha, None


def _quad_logdet_iter(k, resid, probes, cg_iters, lanczos_iters, seed):
    """``(quad, logdet_half)`` of :func:`iterative_gp_nll`; ``seed`` as
    there."""
    zs, zg = _draw_pair(seed, probes, k.shape[-1], k.dtype, k.device, None)
    return _QuadLogdetIter.apply(k, resid, (cg_iters, lanczos_iters, zs, zg))


def iterative_gp_nll(cov, resid, probes=16, cg_iters=100, lanczos_iters=30, seed=0):
    """Matrix-free exact-GP negative log marginal likelihood of a dense
    ``cov``:

      nll = 1/2 resid^T K^{-1} resid + 1/2 log det K + n/2 log 2pi

    the quadratic form by CG, the log det by SLQ, the gradient by the
    Hutchinson probe estimator — products only, no factorization.
    ``seed`` is an int, a ``torch.Generator`` (the SLQ probes, then the
    gradient's, drawn from it) or a dict of the (probes, n) draws ``slq``
    and ``grad``."""
    n = cov.shape[-1]
    quad, logdet_half = _quad_logdet_iter(cov, resid, probes, cg_iters, lanczos_iters, seed)
    return 0.5 * quad + logdet_half + _log2pi_term(n)
