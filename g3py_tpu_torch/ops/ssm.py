"""State-space (SDE) form of 1-D stationary GPs and the parallel Kalman
scans (the PyTorch counterpart of :mod:`g3py_tpu.ops.ssm`).

A stationary GP on a 1-D input whose kernel is OU, Matern-3/2,
Matern-5/2, cosine or the exp-sin^2 periodic (or sums and products of
them) is exactly (for the periodic kernel, to a truncated-harmonic
tolerance) a linear-gaussian state-space model (Hartikainen & Sarkka 2010;
Solin & Sarkka 2014): a latent state z(t) in R^s follows a linear SDE
whose H-projection has the kernel as its stationary covariance.  Exact GP
regression then costs O(n s^3) instead of O(n^3), and the sequential
Kalman recursion becomes the parallel-in-time form of Sarkka &
Garcia-Fernandez ("Temporal Parallelization of Bayesian Smoothers", IEEE
TAC 2021): filtering and smoothing are associative scans of O(log n)
depth.  The SE kernel (and the spectral-mixture component, an SE envelope
times a cosine) is the one approximate leaf: an order-``ssm_se_order``
Taylor spectral factorization.

The kernel parametrization is this library's dense one, so the state-space
NLL equals the dense ``mvn_quad_logdet`` NLL to rounding:

* ``OU``     (ARD_L1): k = v exp(-r|t|)                  -> lambda = r
* ``MAT32``  (ARD_L2): d3 = sqrt(1.5) r |t|              -> lambda = sqrt(1.5) r
* ``MAT52``  (ARD_L2): d5 = sqrt(2.5) r |t|              -> lambda = sqrt(2.5) r
* ``COS``    k = v cos(2 pi f t)                          -> 2-D rotation
* ``SIN``    k = v exp(-2 r sin^2(pi f t))
             = v e^{-r} [I_0(r) + 2 sum_j I_j(r) cos(2 pi f j t)]
* ``SE``/``SM``  the Taylor approximation (:class:`SELeaf`)
* products (KernelProd): Kronecker state composition.

PyTorch has no associative scan: :func:`associative_scan` mirrors
``jax.lax.associative_scan``'s odd/even recursion step for step, so the
combine tree, and with it the float rounding, is the JAX package's.  Every
tensor may carry leading row axes (a params dict of R hyperparameter rows)
ahead of the scanned time axis: R rows are one scan.  The tiny batched
products are ``torch.matmul`` in full FP32 (the JAX package's VPU
multiply-reduce exists only for a TPU's bfloat16 matmul passes).
"""

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import settings
from ..hypers import hval, row_shape
from .iterative import full_fp32, _generator

__all__ = ["ssm_leaves", "ssm_blocks", "ssm_blocks_multi", "parallel_kalman_nll",
           "chunked_kalman_nll", "chunked_smoother_diag", "sharded_ssm_nll",
           "sharded_ssm_nll_multi", "sharded_ssm_nll_payload", "sharded_ssm_laplace",
           "parallel_smoother", "parallel_kalman_filter", "parallel_kalman_quad_logdet",
           "SSMLeaf", "periodic_coefficients", "small_inv", "small_chol",
           "ssm_prior_state_sample", "associative_scan"]

LOG2PI = float(np.log(2.0 * np.pi))
TWOPI = 2.0 * np.pi
_NO_MESH = ("the time-axis-sharded state-space programs are not ported yet "
            "(ROADMAP Queue 1 item 16)")


def _value(h, params):
    """A scalar hyper as a tensor of its row shape: () for one params
    dict, (R,) for R rows (a 1-D time input's rate is a (1,) Param)."""
    v = hval(h, params)
    return v.reshape(row_shape(h, v))


def _eye(s, like):
    return torch.eye(s, dtype=like.dtype, device=like.device)


def _kron(x, y):
    """Kronecker product of the last two axes, leading axes broadcast."""
    out = x[..., :, None, :, None] * y[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (x.shape[-2] * y.shape[-2],
                                          x.shape[-1] * y.shape[-1]))


# ---------------------------------------------------------------------------
# leaves: one kernel component's state-space description
# ---------------------------------------------------------------------------


class SSMLeaf:
    """One kernel component's SSM description.  ``blocks(params, dt)``
    returns the discretized transition stack ``A`` (..., n, s, s), the
    stationary covariance ``Pinf`` (..., s, s) and the measurement row
    ``H`` (s,) numpy; the component's stationary variance is
    ``H Pinf H'``."""

    dim = 0

    def blocks(self, params, dt):
        raise NotImplementedError


class MaternLeaf(SSMLeaf):
    """OU / Matern-3/2 / Matern-5/2 companion-form blocks."""

    def __init__(self, family, kernel, lam_scale, dim):
        self.family = family          # 'ou' | 'mat32' | 'mat52'
        self.kernel = kernel
        self.lam_scale = float(lam_scale)
        self.dim = int(dim)

    def values(self, params):
        """(variance, lambda), each of the rows' shape."""
        v = _value(self.kernel.var, params)
        r = _value(self.kernel.metric.rate, params)
        v, r = torch.broadcast_tensors(v, r)
        return v, self.lam_scale * r

    def blocks(self, params, dt):
        v, lam = self.values(params)
        c = lam[..., None] * dt
        e = torch.exp(-c)
        h = np.zeros(self.dim, settings.floatx)
        h[0] = 1.0
        if self.family == "ou":
            return e[..., None, None], v[..., None, None], h
        one = torch.ones_like(lam)
        if self.family == "mat32":
            # N = F + lam I, F = [[0, 1], [-lam^2, -2 lam]]; N^2 = 0
            n_mat = torch.stack([torch.stack([lam, one], -1),
                                 torch.stack([-lam * lam, -lam], -1)], -2)
            a = e[..., None, None] * (_eye(2, dt) + dt[:, None, None] * n_mat[..., None, :, :])
            return a, torch.diag_embed(torch.stack([v, v * lam * lam], -1)), h
        # mat52: N = F + lam I with N^3 = 0, so expm is the finite series
        z = torch.zeros_like(lam)
        n_mat = torch.stack([torch.stack([lam, one, z], -1),
                             torch.stack([z, lam, one], -1),
                             torch.stack([-lam ** 3, -3.0 * lam * lam, -2.0 * lam], -1)], -2)
        n2 = torch.matmul(n_mat, n_mat)
        a = e[..., None, None] * (_eye(3, dt) + dt[:, None, None] * n_mat[..., None, :, :]
                                  + 0.5 * (dt ** 2)[:, None, None] * n2[..., None, :, :])
        l2 = lam * lam
        k13 = -v * l2 / 3.0
        pinf = torch.stack([torch.stack([v, z, k13], -1),
                            torch.stack([z, v * l2 / 3.0, z], -1),
                            torch.stack([k13, z, v * l2 * l2], -1)], -2)
        return a, pinf, h


def _se_unit_system(order, _cache={}):
    """Host float64 precompute of the unit-lengthscale SE state-space
    approximation (Hartikainen & Sarkka 2010): the Taylor series of 1/S(w)
    truncated at ``order`` terms, spectrally factored (left-half-plane roots
    of ``sum_k (-s^2/2)^k / k!``), and the stationary Lyapunov equation of
    its companion-form SDE solved; returned in balanced coordinates (unit
    diagonal Pinf) and eigen form, so that ``A(dt)[j, k] = Re sum_i
    W[j, k, i] exp(mu_i dt / l)``.  Returns numpy ``(mu_re, mu_im, w_re,
    w_im, pinf)``.  The kernel error is 4.3e-3 / 9.1e-4 / 2.0e-4 / 4.7e-5
    of var at order 6 / 8 / 10 / 12 in float64; in float32 order 10 is the
    ceiling (the eigen constants grow ~13x per +2 orders)."""
    if order in _cache:
        return _cache[order]
    from scipy.linalg import solve_lyapunov

    n = int(order)
    coeffs = np.zeros(2 * n + 1)
    for k in range(n + 1):
        coeffs[2 * k] = (-0.5) ** k / math.factorial(k)
    roots = np.roots(coeffs[::-1])
    lhp = roots[roots.real < 0]
    if len(lhp) != n:  # pragma: no cover
        raise ValueError(f"SE spectral factorization failed at order {n}")
    d_poly = np.poly(lhp).real
    f_mat = np.zeros((n, n))
    f_mat[:-1, 1:] = np.eye(n - 1)
    f_mat[-1, :] = -d_poly[::-1][:n]
    l_vec = np.zeros(n)
    l_vec[-1] = 1.0
    q_c = np.sqrt(2.0 * np.pi) * (2.0 ** n) * math.factorial(n)
    pinf = solve_lyapunov(f_mat, -q_c * np.outer(l_vec, l_vec))
    pinf = 0.5 * (pinf + pinf.T)
    pinf = pinf / pinf[0, 0]
    mu, v_eig = np.linalg.eig(f_mat)
    w_full = np.einsum("ji,ik->jki", v_eig, np.linalg.inv(v_eig))
    t_bal = 1.0 / np.sqrt(np.diag(pinf))
    pinf = pinf * np.outer(t_bal, t_bal)
    w_full = w_full * (t_bal[:, None, None] / t_bal[None, :, None])
    _cache[order] = (np.ascontiguousarray(mu.real), np.ascontiguousarray(mu.imag),
                     np.ascontiguousarray(w_full.real), np.ascontiguousarray(w_full.imag), pinf)
    return _cache[order]


def _se_discretize(order, c):
    """(A (..., n, s, s), Pinf_unit (s, s)) of the balanced SE unit system
    at scaled steps ``c = rate * dt`` (..., n): A = Re(W e^{mu c}), one
    product with the (s*s, s) eigen constants."""
    mu_re, mu_im, w_re, w_im, pinf_u = _se_unit_system(order)

    def t(a):
        return torch.as_tensor(a, dtype=c.dtype, device=c.device)

    s = int(order)
    decay = torch.exp(c[..., None] * t(mu_re))
    phase = c[..., None] * t(mu_im)
    a = (torch.matmul(decay * torch.cos(phase), t(w_re).reshape(s * s, s).T)
         - torch.matmul(decay * torch.sin(phase), t(w_im).reshape(s * s, s).T))
    return a.reshape(a.shape[:-1] + (s, s)), t(pinf_u)


class SELeaf(SSMLeaf):
    """SE kernel (v exp(-0.5 r^2 tau^2)) as an order-``s`` Taylor
    state-space approximation, the one non-exact leaf: kernel error <= 9.1e-4
    of var at the default order 8 (``settings.ssm_se_order``), uniform in
    the lengthscale; ``A(dt) = Re sum_i W_i e^{mu_i r dt}``."""

    def __init__(self, kernel, order):
        self.kernel = kernel
        self.dim = int(order)

    def blocks(self, params, dt):
        v = _value(self.kernel.var, params)
        r = _value(self.kernel.metric.rate, params)
        a, pinf_u = _se_discretize(self.dim, r[..., None] * dt)
        h = np.zeros(self.dim, settings.floatx)
        h[0] = 1.0
        return a, v[..., None, None] * pinf_u, h


def _rotation_stack(omega, dt):
    """(..., n, 2, 2) rotations by the angle omega*dt (the cosine kernel's
    exact transition: H A(tau) Pinf H' = v cos(omega tau))."""
    th = omega[..., None] * dt
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


class SMLeaf(SSMLeaf):
    """Spectral-mixture component (v exp(-2 pi^2 r^2 tau^2) cos(2 pi f
    tau)) as the Kronecker product of the SE envelope leaf (an SE at rate
    2 pi r) and the exact 2-D rotation: :class:`SELeaf`'s accuracy at the
    same order."""

    def __init__(self, kernel, order):
        self.kernel = kernel
        self.order = int(order)
        self.dim = 2 * self.order

    def blocks(self, params, dt):
        v = _value(self.kernel.var, params)
        r = _value(self.kernel.rate, params)
        f = _value(self.kernel.freq, params)
        a1, p1 = _se_discretize(self.order, (TWOPI * r)[..., None] * dt)
        a2 = _rotation_stack(TWOPI * f, dt)
        pinf = v[..., None, None] * _kron(p1, _eye(2, dt))
        h = np.zeros(self.dim, settings.floatx)
        h[0] = 1.0                       # kron(e0_se, e0_rot)
        return _kron(a1, a2), pinf, h


class CosLeaf(SSMLeaf):
    """COS kernel (v cos(2 pi f tau)): the exact 2-D rotation, Q = 0."""

    dim = 2

    def __init__(self, kernel):
        self.kernel = kernel

    def blocks(self, params, dt):
        v = _value(self.kernel.var, params)
        f = _value(self.kernel.freq, params)
        h = np.zeros(2, settings.floatx)
        h[0] = 1.0
        return _rotation_stack(TWOPI * f, dt), v[..., None, None] * _eye(2, dt), h


def periodic_coefficients(r, harmonics, terms=64):
    """Harmonic variances of the exp-sin^2 periodic kernel: ``c`` (...,
    harmonics + 1) with ``c[0] = e^{-r} I_0(r)``, ``c[j] = 2 e^{-r} I_j(r)``,
    so that exp(-2 r sin^2(pi f tau)) = sum_j c_j cos(2 pi f j tau) exactly
    as harmonics -> inf; the ascending series of I_j in the log domain,
    differentiable in ``r`` and accurate in float32 for r up to ~30."""
    r = torch.as_tensor(r, dtype=settings.dtype)
    kw = dict(dtype=r.dtype, device=r.device)
    j = torch.arange(harmonics + 1, **kw)[:, None]
    k = torch.arange(terms, **kw)[None, :]
    # ln(r/2) guarded at r -> 0: the terms with 2k+j > 0 vanish anyway
    logr2 = torch.log(torch.clamp(r, min=1e-30) / 2.0)[..., None, None]
    logterm = ((2.0 * k + j) * logr2 - torch.lgamma(k + 1.0) - torch.lgamma(k + j + 1.0)
               - r[..., None, None])
    i_scaled = torch.exp(logterm).sum(dim=-1)          # e^{-r} I_j(r)
    scale = torch.cat([torch.ones(1, **kw), torch.full((harmonics,), 2.0, **kw)])
    return scale * i_scaled


class PeriodicLeaf(SSMLeaf):
    """SIN kernel (v exp(-2 r sin^2(pi f tau))) as a truncated sum of
    ``harmonics`` cosine blocks plus a constant (j=0) state; the tail
    sum_{j>J} 2 e^{-r} I_j(r) is below float32 resolution for J >= ~r + 8."""

    def __init__(self, kernel, harmonics):
        self.kernel = kernel
        self.harmonics = int(harmonics)
        self.dim = 1 + 2 * self.harmonics

    def blocks(self, params, dt):
        v = _value(self.kernel.var, params)
        f = _value(self.kernel.freq, params)
        r = _value(self.kernel.rate, params)
        c = periodic_coefficients(r, self.harmonics)     # (..., J+1)
        lead = torch.broadcast_shapes(v.shape, f.shape, r.shape)
        s, n = self.dim, dt.shape[0]
        vc = v[..., None] * c
        a = torch.zeros(lead + (n, s, s), dtype=dt.dtype, device=dt.device)
        pinf = torch.zeros(lead + (s, s), dtype=dt.dtype, device=dt.device)
        h = np.zeros(s, settings.floatx)
        a[..., 0, 0] = 1.0                # j = 0: a random constant
        pinf[..., 0, 0] = vc[..., 0]
        h[0] = 1.0
        for jh in range(1, self.harmonics + 1):
            o = 1 + 2 * (jh - 1)
            a[..., o:o + 2, o:o + 2] = _rotation_stack(TWOPI * f * jh, dt)
            pinf[..., o, o] = vc[..., jh]
            pinf[..., o + 1, o + 1] = vc[..., jh]
            h[o] = 1.0
        return a, pinf, h


class ProductLeaf(SSMLeaf):
    """Kernel product by Kronecker state composition: (A1 (x) A2, P1 (x)
    P2, H1 (x) H2), so H A(tau) P H' = k1(tau) k2(tau) — the
    quasi-periodic construction (SIN * MAT32)."""

    def __init__(self, left, right):
        self.left = left
        self.right = right
        self.dim = left.dim * right.dim

    def blocks(self, params, dt):
        a1, p1, h1 = self.left.blocks(params, dt)
        a2, p2, h2 = self.right.blocks(params, dt)
        return _kron(a1, a2), _kron(p1, p2), np.kron(h1, h2).astype(settings.floatx)


def _leaf_of(k, harmonics):
    """One non-composite kernel -> SSMLeaf, or raise naming the part."""
    from ..hypers.kernels import OU, MAT32, MAT52, COS, SIN, SE, SM, KernelProd
    from ..hypers.metrics import ARD_L1, ARD_L2

    if isinstance(k, KernelProd):
        return ProductLeaf(_leaf_of(k.k1, harmonics), _leaf_of(k.k2, harmonics))
    if isinstance(k, (MAT32, MAT52)):
        if type(k.metric) is not ARD_L2:
            raise ValueError(f"{type(k).__name__} needs its default ARD_L2 metric "
                             "for the state-space form")
        fam = "mat32" if isinstance(k, MAT32) else "mat52"
        scale = np.sqrt(1.5) if fam == "mat32" else np.sqrt(2.5)
        return MaternLeaf(fam, k, scale, 2 if fam == "mat32" else 3)
    if isinstance(k, OU):
        if type(k.metric) is not ARD_L1:
            raise ValueError("OU needs its default ARD_L1 metric for the state-space form")
        return MaternLeaf("ou", k, 1.0, 1)
    if isinstance(k, SE):
        if type(k.metric) is not ARD_L2:
            raise ValueError("SE needs its default ARD_L2 metric for the state-space form")
        return SELeaf(k, settings.ssm_se_order)
    if isinstance(k, SM):
        return SMLeaf(k, settings.ssm_se_order)
    if isinstance(k, COS):
        return CosLeaf(k)
    if isinstance(k, SIN):
        return PeriodicLeaf(k, harmonics)
    raise ValueError(
        f"kernel part {type(k).__name__} has no state-space form (supported: OU, MAT32, "
        "MAT52, SE/SM — approximate, order settings.ssm_se_order — COS, SIN and their "
        "sums/products; use the dense/sparse families otherwise)")


def ssm_leaves(kernel, harmonics=None):
    """Host walk of a kernel tree into :class:`SSMLeaf` blocks: sums become
    additive block-diagonal leaves, products Kronecker
    :class:`ProductLeaf`; atoms OU, MAT32, MAT52, SE, SM, COS and SIN
    (truncated at ``harmonics`` cosine terms, default
    ``settings.ssm_harmonics``)."""
    from ..hypers.kernels import KernelSum

    if harmonics is None:
        harmonics = settings.ssm_harmonics
    out, stack = [], [kernel]
    while stack:
        k = stack.pop(0)
        if isinstance(k, KernelSum):
            stack = [k.k1, k.k2] + stack
            continue
        out.append(_leaf_of(k, harmonics))
    return out


def _block_diag(parts, lead, n=None):
    """Block-diagonal (lead [+ (n,)] + (S, S)) from (..., d, d) parts, by
    index writes into one zero tensor."""
    s = sum(p.shape[-1] for p in parts)
    mid = () if n is None else (n,)
    out = parts[0].new_zeros(lead + mid + (s, s))
    off = 0
    for p in parts:
        d = p.shape[-1]
        out[..., off:off + d, off:off + d] = p
        off += d
    return out


def _prior_first(a, q, pinf):
    """Row 0 of (A, Q) set to (0, Pinf): the first step starts from the
    stationary prior exactly."""
    a = torch.cat([torch.zeros_like(a[..., :1, :, :]), a[..., 1:, :, :]], dim=-3)
    q0 = pinf[..., None, :, :].expand(q.shape[:-3] + (1,) + q.shape[-2:])
    return a, torch.cat([q0, q[..., 1:, :, :]], dim=-3)


def ssm_blocks(leaves, params, dt, stationary_first=True):
    """The additive kernel's leaf SSMs stacked into one block-diagonal model
    over the step vector ``dt`` (n,): ``A`` (..., n, s, s), ``Q`` (..., n,
    s, s), ``Pinf`` (..., s, s), ``H`` (s,).  Row 0's A is zero and its Q
    Pinf (the exact stationary prior x_1 ~ N(0, Pinf) through the uniform
    filter element) unless ``stationary_first=False``."""
    with full_fp32():
        mats = [leaf.blocks(params, dt) for leaf in leaves]
        h = torch.as_tensor(np.concatenate([m[2] for m in mats]), dtype=dt.dtype,
                            device=dt.device)
        if len(mats) == 1:
            a, pinf = mats[0][0], mats[0][1]
        else:
            lead = torch.broadcast_shapes(*[m[0].shape[:-3] for m in mats],
                                          *[m[1].shape[:-2] for m in mats])
            a = _block_diag([m[0] for m in mats], lead, dt.shape[0])
            pinf = _block_diag([m[1] for m in mats], lead)
        # Q = Pinf - A Pinf A' is a cancellation-prone difference (Q -> 0 as
        # dt -> 0): full-FP32 products
        pb = pinf[..., None, :, :]
        q = pb - torch.matmul(a, torch.matmul(pb, _bt(a)))
        pinf = pinf.expand(q.shape[:-3] + pinf.shape[-2:])
        a = a.expand(q.shape)
        if stationary_first:
            a, q = _prior_first(a, q, pinf)
    return a, q, pinf, h


def ssm_blocks_multi(leaf_sets, params, dt, stationary_first=True):
    """Block-diagonal stack of Q independent latent SSMs (the state model of
    the LMC-mixed multi-output state-space GP): ``A`` (..., n, S, S), ``Q``
    (..., n, S, S), ``Pinf`` (..., S, S) and ``Hq`` (Q, S), S = sum_q s_q,
    row q of ``Hq`` latent q's emission vector in its own state segment.
    Entries of ``leaf_sets`` that are the same list object (a shared
    kernel) are built once; Q copies of one block are one Kronecker
    product with the identity."""
    mats, cache = [], {}
    for leaves in leaf_sets:
        key = id(leaves)
        if key not in cache:
            cache[key] = ssm_blocks(leaves, params, dt, stationary_first=stationary_first)
        mats.append(cache[key])
    nq = len(leaf_sets)
    dims = [int(m[3].shape[0]) for m in mats]
    hq = torch.zeros((nq, sum(dims)), dtype=dt.dtype, device=dt.device)
    off = 0
    for i, m in enumerate(mats):
        hq[i, off:off + dims[i]] = m[3]
        off += dims[i]
    if len(cache) == 1:
        a_l, q_l, p_l, _ = mats[0]
        eye = _eye(nq, dt)
        return _kron(eye, a_l), _kron(eye, q_l), _kron(eye, p_l), hq
    lead = torch.broadcast_shapes(*[m[0].shape[:-3] for m in mats])
    n = dt.shape[0]
    return (_block_diag([m[0] for m in mats], lead, n), _block_diag([m[1] for m in mats], lead, n),
            _block_diag([m[2] for m in mats], lead), hq)


# ---------------------------------------------------------------------------
# the small algebra
# ---------------------------------------------------------------------------


def _bmm(x, y):
    """Batched tiny-matrix product (full FP32 under the callers'
    ``full_fp32``)."""
    return torch.matmul(x, y)


def _bmv(x, v):
    """Batched tiny matrix @ vector: (..., s, s) x (..., s) -> (..., s)."""
    return torch.matmul(x, v[..., None])[..., 0]


def _bvm(v, x):
    """Batched vector @ matrix (x' v): (..., s) x (..., s, s) -> (..., s)."""
    return torch.matmul(v[..., None, :], x)[..., 0, :]


def _bt(x):
    return x.transpose(-1, -2)


def small_inv(m):
    """Batched inverse of small well-conditioned matrices by unrolled
    Gauss-Jordan (no pivoting): every matrix inverted in the Kalman combines
    is I + (PSD)(PSD) or a PD predicted covariance, strongly diagonally
    dominant.  The pivot row and pivot are copied out of the augmented
    matrix, so autograd keeps O(s) a step, not the whole (..., s, 2s)
    matrix of every step."""
    s = m.shape[-1]
    eye = _eye(s, m)
    aug = torch.cat([m, eye.expand(m.shape)], dim=-1)          # (..., s, 2s)
    for i in range(s):
        piv = aug[..., i:i + 1, i:i + 1].clone()
        row = aug[..., i:i + 1, :].clone() / piv
        col = aug[..., :, i:i + 1]
        # one update clears column i in all other rows and normalizes row i
        aug = aug - (col - eye[:, i:i + 1]) * row
    return aug[..., s:]


def small_chol(m):
    """Batched tiny-matrix Cholesky, unrolled (Cholesky-Banachiewicz) and
    PSD-singular-safe: a zero pivot gives a zero factor column instead of
    NaN — exact for the rotation blocks whose Q is identically 0 (COS/SIN)
    and for the dt=0 duplicate-time rows."""
    s = m.shape[-1]
    idx = torch.arange(s, device=m.device)
    cols = []
    for j in range(s):
        if cols:
            lj = torch.stack(cols, dim=-1)                       # (..., s, j)
            d = m[..., j, j] - (lj[..., j, :] ** 2).sum(dim=-1)
            acc = (lj * lj[..., j:j + 1, :]).sum(dim=-1)
        else:
            d = m[..., j, j]
            acc = torch.zeros_like(m[..., :, j])
        dsafe = torch.sqrt(torch.clamp(d, min=0.0))
        pos = dsafe > 0.0
        inv = torch.where(pos, 1.0 / torch.where(pos, dsafe, torch.ones_like(dsafe)),
                          torch.zeros_like(dsafe))
        col = (m[..., :, j] - acc) * inv[..., None]
        col = torch.where(idx > j, col, torch.zeros_like(col))
        cols.append(torch.where(idx == j, dsafe[..., None], col))
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


def _slice(x, dim, start, stop=None, step=1):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a, b, dim):
    """a[0], b[0], a[1], b[1], ... along ``dim`` (a one longer, or equal)."""
    nb = b.shape[dim]
    head = torch.stack([_slice(a, dim, 0, nb), b], dim=dim + 1).flatten(dim, dim + 1)
    if a.shape[dim] == nb:
        return head
    return torch.cat([head, _slice(a, dim, nb)], dim=dim)


def associative_scan(fn, elems, reverse=False, dim=0):
    """Inclusive scan of the tuple ``elems`` under the associative ``fn``
    along ``dim`` (the axes before it are batch axes): the odd/even
    recursion of ``jax.lax.associative_scan`` step for step (pair-combine,
    recurse, combine the evens, prepend the first element, interleave), so
    the combine tree is JAX's.  ``reverse`` flips before and after, and
    ``fn`` then receives (later suffix, earlier) as JAX's does."""
    elems = list(elems)
    if reverse:
        elems = [torch.flip(e, dims=(dim,)) for e in elems]

    def combine(a, b):
        return list(fn(tuple(a), tuple(b)))

    def _scan(elems):
        num = elems[0].shape[dim]
        if num < 2:
            return elems
        reduced = combine([_slice(e, dim, 0, -1, 2) for e in elems],
                          [_slice(e, dim, 1, None, 2) for e in elems])
        odd = _scan(reduced)
        if num % 2 == 0:
            even = combine([_slice(e, dim, 0, -1) for e in odd],
                           [_slice(e, dim, 2, None, 2) for e in elems])
        else:
            even = combine(odd, [_slice(e, dim, 2, None, 2) for e in elems])
        even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
        return [_interleave(ev, od, dim) for ev, od in zip(even, odd)]

    out = _scan(elems)
    if reverse:
        out = [torch.flip(e, dims=(dim,)) for e in out]
    return tuple(out)


def _common_batch(elems, ranks):
    """Expand every element to one batch shape (the axes before the scanned
    one; ``ranks`` are the event ranks after it); returns (elems, dim)."""
    leads = [e.shape[:e.ndim - r - 1] for e, r in zip(elems, ranks)]
    lead = torch.broadcast_shapes(*leads)
    out = tuple(e.expand(lead + e.shape[e.ndim - r - 1:]) for e, r in zip(elems, ranks))
    return out, len(lead)


_FILTER_RANKS = (2, 1, 2, 1, 2)
_SMOOTHER_RANKS = (2, 1, 2)


def ssm_prior_state_sample(a, q, key):
    """Joint draws of the latent state trajectory x ~ N(0, SSM prior): the
    recurrence x_k = A_k x_{k-1} + w_k, w_k ~ N(0, Q_k), as one associative
    scan over (A, w) pairs with composition (A2 A1, A2 w1 + w2).  Row 0's
    (A=0, Q=Pinf) makes x_1 ~ N(0, Pinf) exactly.  ``key`` is a seed or a
    ``torch.Generator`` (one (n, s) draw), or the standard normals
    themselves, (..., n, s): a leading draw axis gives that many
    trajectories."""
    with full_fp32():
        if isinstance(key, torch.Tensor):
            eps = key.to(dtype=a.dtype, device=a.device)
        else:
            eps = torch.randn(a.shape[:-1], generator=_generator(key, a.device),
                              dtype=a.dtype, device=a.device)
        w = _bmv(small_chol(q), eps)

        def comb(e1, e2):
            a1, b1 = e1
            a2, b2 = e2
            return _bmm(a2, a1), _bmv(a2, b1) + b2

        (aa, ww), dim = _common_batch((a, w), (2, 1))
        return associative_scan(comb, (aa, ww), dim=dim)[1]


# ---------------------------------------------------------------------------
# the filter, the NLL and the smoother
# ---------------------------------------------------------------------------


def _filter_elements(a, q, h, r, y, obs):
    """Per-step associative filtering elements (Sarkka & G-F 2021 eq. 10)
    for a scalar measurement y_k = h'x_k + N(0, r), ``obs`` masking the rows
    that carry no observation.  ``h`` is a shared (s,) vector or per row
    (..., n, s); ``r`` broadcasts against ``y`` (..., n)."""
    hb = h.expand(torch.broadcast_shapes(h.shape, a.shape[:-1]))
    qh = _bmv(q, hb)                                   # Q H'
    s = (qh * hb).sum(dim=-1) + r                      # H Q H' + r
    k = qh / s[..., None]                              # gain
    k = torch.where(obs[:, None], k, torch.zeros_like(k))
    ikh = _eye(a.shape[-1], a) - k[..., :, None] * hb[..., None, :]
    a_e = _bmm(ikh, a)
    b_e = k * y[..., None]
    c_e = _bmm(ikh, q)
    ah = _bvm(hb, a)                                   # A' H
    w = torch.where(obs, 1.0 / s, torch.zeros_like(s))
    eta = ah * (w * y)[..., None]
    j_e = ah[..., :, None] * ah[..., None, :] * w[..., None, None]
    return a_e, b_e, c_e, eta, j_e


def _filter_combine(e1, e2):
    """Associative combination of filtering elements (earlier, later)."""
    a1, b1, c1, n1, j1 = e1
    a2, b2, c2, n2, j2 = e2
    m = _eye(a1.shape[-1], a1) + _bmm(c1, j2)
    # C1, J2 are symmetric, so I + J2 C1 = M': one inverse serves both
    minv = small_inv(m)
    mtinv = _bt(minv)
    a = _bmm(a2, _bmm(minv, a1))
    b = _bmv(a2, _bmv(minv, b1 + _bmv(c1, n2))) + b2
    minv_c1 = _bmm(minv, c1)
    c = _bmm(a2, _bmm(minv_c1, _bt(a2))) + c2
    w = _bmv(mtinv, n2 - _bmv(j2, b1))
    eta = _bvm(w, a1) + n1
    j = _bmm(_bt(a1), _bmm(_bmm(mtinv, j2), a1)) + j1
    return a, b, c, eta, j


def _filter_scan(elems):
    elems, dim = _common_batch(elems, _FILTER_RANKS)
    return associative_scan(_filter_combine, elems, dim=dim)


def parallel_kalman_filter(a, q, h, r, y, obs=None):
    """Parallel-in-time Kalman filter: filtered means (..., n, s) and
    covariances (..., n, s, s) from one associative scan (log depth)."""
    if obs is None:
        obs = torch.ones(y.shape[-1], dtype=torch.bool, device=y.device)
    with full_fp32():
        _, m_f, p_f, _, _ = _filter_scan(_filter_elements(a, q, h, r, y, obs))
    return m_f, p_f


def _innovation_moments(a, q, h, r, m_f, p_f):
    """Per-row one-step-ahead predictive moments (mu_k, sig_k) from the
    filtered moments shifted by one step; ``h``/``r`` may be per row."""
    m_prev = torch.cat([torch.zeros_like(m_f[..., :1, :]), m_f[..., :-1, :]], dim=-2)
    p_prev = torch.cat([torch.zeros_like(p_f[..., :1, :, :]), p_f[..., :-1, :, :]], dim=-3)
    m_pred = _bmv(a, m_prev)
    p_pred = _bmm(a, _bmm(p_prev, _bt(a))) + q
    hb = h.expand(torch.broadcast_shapes(h.shape, m_pred.shape))
    mu = (m_pred * hb).sum(dim=-1)
    sig = (_bmv(p_pred, hb) * hb).sum(dim=-1) + r
    return mu, sig


def parallel_kalman_nll(a, q, h, r, y, obs=None):
    """Exact negative log marginal likelihood -log p(y) of the LGSSM and
    the filtered moments: ``(nll, m_f, P_f)``; the per-step terms log N(y_k;
    H m_k^-, H P_k^- H' + r) come pointwise from the scan's output shifted
    by one step.  ``h``/``r`` may be per row."""
    if obs is None:
        obs = torch.ones(y.shape[-1], dtype=torch.bool, device=y.device)
    with full_fp32():
        m_f, p_f = parallel_kalman_filter(a, q, h, r, y, obs)
        mu, sig = _innovation_moments(a, q, h, r, m_f, p_f)
    ll = -0.5 * (LOG2PI + torch.log(sig) + (y - mu) ** 2 / sig)
    return -torch.where(obs, ll, torch.zeros_like(ll)).sum(dim=-1), m_f, p_f


def parallel_kalman_quad_logdet(a, q, h, r, y, obs=None):
    """(quad, logdet) split of the Gaussian NLL's innovation decomposition:
    ``logdet = sum_k log sig_k`` (the full log-determinant of K + diag(r))
    and ``quad = sum_k v_k^2 / sig_k = y' (K + diag(r))^{-1} y``."""
    if obs is None:
        obs = torch.ones(y.shape[-1], dtype=torch.bool, device=y.device)
    with full_fp32():
        m_f, p_f = parallel_kalman_filter(a, q, h, r, y, obs)
        mu, sig = _innovation_moments(a, q, h, r, m_f, p_f)
    zero = torch.zeros_like(sig)
    quad = torch.where(obs, (y - mu) ** 2 / sig, zero).sum(dim=-1)
    return quad, torch.where(obs, torch.log(sig), zero).sum(dim=-1)


def _filter_identity(s, dtype, device=None):
    """The filter monoid's identity element: (A=I, b=0, C=0, eta=0, J=0)."""
    z_v = torch.zeros(s, dtype=dtype, device=device)
    z_m = torch.zeros((s, s), dtype=dtype, device=device)
    return torch.eye(s, dtype=dtype, device=device), z_v, z_m, z_v, z_m


def _rows_hr(idxb, rows):
    """Per-row emission vectors and noise variances of a block of output
    indices ``idxb`` from ``rows = (w, hq, r_vec)``: ``h_k = sum_q W[p_k,
    q] Hq[q]``, ``r_k = r_vec[p_k]``."""
    w, hq, r_vec = rows
    return torch.matmul(w[..., idxb, :], hq), r_vec[..., idxb]


def _smoother_combine(e1, e2):
    """Combination of smoothing elements.  Under ``reverse=True``
    :func:`associative_scan` passes (accumulated later suffix, earlier),
    so ``e2`` is the earlier element and the composition is earlier o
    later."""
    g1, h1, l1 = e1                                    # later suffix
    g2, h2, l2 = e2                                    # earlier
    g = _bmm(g2, g1)
    hh = _bmv(g2, h1) + h2
    ll = _bmm(g2, _bmm(l1, _bt(g2))) + l2
    return g, hh, ll


def _smoother_scan(elems):
    elems, dim = _common_batch(elems, _SMOOTHER_RANKS)
    return associative_scan(_smoother_combine, elems, reverse=True, dim=dim)


def parallel_smoother(a, q, m_f, p_f):
    """Parallel RTS smoother from the filtered moments: smoothed means
    (..., n, s) and covariances (..., n, s, s) from one reverse associative
    scan."""
    s = m_f.shape[-1]
    with full_fp32():
        a_n = a[..., 1:, :, :]                         # A_{k+1}, k = 0..n-2
        p_k, m_k = p_f[..., :-1, :, :], m_f[..., :-1, :]
        p_pred = _bmm(a_n, _bmm(p_k, _bt(a_n))) + q[..., 1:, :, :]
        # E_k = P_k A_{k+1}' P_pred^{-1} (P_pred is PD: small_inv is safe)
        e_k = _bmm(p_k, _bmm(_bt(a_n), small_inv(p_pred)))
        g_k = m_k - _bmv(e_k, _bmv(a_n, m_k))
        l_k = p_k - _bmm(e_k, _bmm(p_pred, _bt(e_k)))
        g = torch.cat([e_k, e_k.new_zeros(e_k.shape[:-3] + (1, s, s))], dim=-3)
        hh = torch.cat([g_k, m_f[..., -1:, :].expand(g_k.shape[:-2] + (1, s))], dim=-2)
        ll = torch.cat([l_k, p_f[..., -1:, :, :].expand(l_k.shape[:-3] + (1, s, s))], dim=-3)
        _, m_s, p_s = _smoother_scan((g, hh, ll))
    return m_s, p_s


# ---------------------------------------------------------------------------
# the beyond-memory paths: blocks of ``chunk`` rows, the prefix carried
# ---------------------------------------------------------------------------


def _pad_fills(identity, s, like):
    """The pad rows' (A, Q): the filter monoid's identity (I, 0) for the
    NLL, (0, I) for the smoother (A=0 ends the backward recursion with the
    filtered moments)."""
    eye = _eye(s, like)
    return (eye, torch.zeros_like(eye)) if identity else (torch.zeros_like(eye), eye)


def _chunk_layout(a, q, y, obs, rows, blocks_fn, dt, pinf, chunk, identity):
    """Pad the inputs to whole blocks: (a, q, dt, y, obs, feed, payload
    mode, s, chunk, nc, n).  Pads are :func:`_pad_fills` transitions,
    unobserved; a payload pads with a real row's features (its rows_fn
    stays in domain)."""
    n = y.shape[-1]
    if obs is None:
        obs = torch.ones(n, dtype=torch.bool, device=y.device)
    s = a.shape[-1] if blocks_fn is None else pinf.shape[-1]
    chunk = int(min(chunk, n))
    nc = -(-n // chunk)
    pad = nc * chunk - n
    payload = rows is not None and callable(rows[1])
    feed = None
    if rows is not None:
        feed = rows[0] if payload else rows[0].to(torch.int64)
    if pad:
        if blocks_fn is None:
            fill_a, fill_q = _pad_fills(identity, s, a)
            a = torch.cat([a, fill_a.expand(a.shape[:-3] + (pad, s, s))], dim=-3)
            q = torch.cat([q, fill_q.expand(q.shape[:-3] + (pad, s, s))], dim=-3)
        else:
            dt = torch.cat([dt, dt.new_zeros(pad)])
        y = torch.cat([y, y.new_zeros(y.shape[:-1] + (pad,))], dim=-1)
        obs = torch.cat([obs, obs.new_zeros(pad)])
        if payload:
            feed = torch.cat([feed, feed[:, :1].expand(feed.shape[0], pad)], dim=1)
        elif feed is not None:
            feed = torch.cat([feed, feed.new_zeros(pad)])
    return a, q, dt, y, obs, feed, payload, s, chunk, nc, n


def _block_hr(h, r, rows, payload, feed_b):
    if rows is None:
        return h, r
    if payload:
        return rows[1](feed_b)
    return _rows_hr(feed_b, rows[1:])


def _block_feed(feed, payload, sl):
    if feed is None:
        return None
    return feed[:, sl] if payload else feed[sl]


def _block_aq(a, q, dt, blocks_fn, pinf, bi, chunk, n, sl, identity):
    """One block's (A, Q): sliced, or built from its steps with the global
    first row's stationary prior and the pad rows' fill."""
    if blocks_fn is None:
        return a[..., sl, :, :], q[..., sl, :, :]
    ab, qb = blocks_fn(dt[sl])
    s = ab.shape[-1]
    if (bi + 1) * chunk > n:                 # the last block's pad rows
        valid = torch.arange(bi * chunk, (bi + 1) * chunk, device=ab.device) < n
        fill_a, fill_q = _pad_fills(identity, s, ab)
        v = valid[:, None, None]
        ab = torch.where(v, ab, fill_a)
        qb = torch.where(v, qb, fill_q)
    if bi == 0:
        ab, qb = _prior_first(ab, qb, pinf.expand(qb.shape[:-3] + pinf.shape[-2:]))
    return ab, qb


def _local_filter(start, ab, qb, hb, rb, yb, ob):
    """The block's filtered prefixes: the carried prefix o the block's own
    scan."""
    pref = _filter_scan(_filter_elements(ab, qb, hb, rb, yb, ob))
    carry = tuple(x[..., None, :] if rk == 1 else x[..., None, :, :]
                  for x, rk in zip(start, _FILTER_RANKS))
    return _filter_combine(carry, pref)


def chunked_kalman_nll(a, q, h, r, y, obs=None, chunk=262_144, rows=None, blocks_fn=None,
                       dt=None, pinf=None, split=False):
    """Exact LGSSM NLL with O(chunk) activation memory: a loop over blocks
    of ``chunk`` rows, each block's associative scan recomputed in the
    backward (``torch.utils.checkpoint``), the running prefix element
    carried across blocks (the filter elements form a monoid, so blocking
    is exact).  Returns the NLL only (the training path).

    ``rows=(idx, w, hq, r_vec)`` is the per-row-emission form (the
    LMC-mixed multi-output SSM): ``idx`` (n,) output index a row, ``w``
    (..., P, Q) mixing, ``hq`` (Q, s), ``r_vec`` (..., P); ``h``/``r`` are
    ignored and each block builds its own.  ``blocks_fn=(dt_block -> (A,
    Q))`` with ``dt`` (n,) and ``pinf`` builds each block's transitions on
    the fly (large state dims); the global first row's prior and the pads
    are applied here.  ``rows=(payload_T, rows_fn)`` with a callable is the
    payload form: ``payload_T`` (k, n) row features, ``rows_fn(payload_block
    (k, c)) -> (h (..., c, s), r (..., c))``.  ``split=True`` returns the
    ``(quad, logdet)`` split (:func:`parallel_kalman_quad_logdet`)."""
    # identity-element pads (A=I, Q=0, unobserved -> (I, 0, 0, 0, 0))
    a, q, dt, y, obs, feed, payload, s, chunk, nc, n = _chunk_layout(
        a, q, y, obs, rows, blocks_fn, dt, pinf, chunk, True)

    def body(bi, *prev):
        sl = slice(bi * chunk, (bi + 1) * chunk)
        with full_fp32():
            ab, qb = _block_aq(a, q, dt, blocks_fn, pinf, bi, chunk, n, sl, True)
            hb, rb = _block_hr(h, r, rows, payload, _block_feed(feed, payload, sl))
            yb, ob = y[..., sl], obs[sl]
            full = _local_filter(prev, ab, qb, hb, rb, yb, ob)
            m_f, p_f = full[1], full[2]
            lead = m_f.shape[:-2]
            m_prev = torch.cat([prev[1].expand(lead + prev[1].shape[-1:])[..., None, :],
                                m_f[..., :-1, :]], dim=-2)
            p_prev = torch.cat([prev[2].expand(lead + prev[2].shape[-2:])[..., None, :, :],
                                p_f[..., :-1, :, :]], dim=-3)
            m_pred = _bmv(ab, m_prev)
            p_pred = _bmm(ab, _bmm(p_prev, _bt(ab))) + qb
            hrow = hb.expand(torch.broadcast_shapes(hb.shape, m_pred.shape))
            mu = (m_pred * hrow).sum(dim=-1)
            sig = (_bmv(p_pred, hrow) * hrow).sum(dim=-1) + rb
        zero = torch.zeros_like(sig)
        if split:
            out = torch.stack([torch.where(ob, (yb - mu) ** 2 / sig, zero).sum(dim=-1),
                               torch.where(ob, torch.log(sig), zero).sum(dim=-1)], dim=-1)
        else:
            ll = -0.5 * (LOG2PI + torch.log(sig) + (yb - mu) ** 2 / sig)
            out = -torch.where(ob, ll, zero).sum(dim=-1)
        return tuple(x[..., -1, :] if rk == 1 else x[..., -1, :, :]
                     for x, rk in zip(full, _FILTER_RANKS)) + (out,)

    prev = _filter_identity(s, y.dtype, y.device)
    acc = None
    for bi in range(nc):
        *prev, out = checkpoint(functools.partial(body, bi), *prev, use_reentrant=False)
        acc = out if acc is None else acc + out
    if split:
        return acc[..., 0], acc[..., 1]
    return acc


def chunked_smoother_diag(a, q, h, r, y, obs=None, chunk=262_144, rows=None, blocks_fn=None,
                          dt=None, pinf=None):
    """H-projected smoothed posterior (mean, var), each (..., n), with
    O(chunk) live memory (the beyond-memory serving path): a forward pass
    over blocks storing only the block-start filter prefixes, then a
    backward pass that recomputes each block's filter from its stored
    prefix, builds its smoothing elements (the block's last row uses the
    next block's first (A, Q); the global last row gets (0, m_f, P_f): the
    pad rows' A=0 make that automatic), reverse-scans them and folds in the
    suffix carried from the later blocks.  Pads are (A=0, Q=I,
    unobserved).  ``rows``, ``blocks_fn``/``dt``/``pinf``: as in
    :func:`chunked_kalman_nll` (per-row forms give the mixed projections
    h_k' m_s and h_k' P_s h_k)."""
    a, q, dt, y, obs, feed, payload, s, chunk, nc, n = _chunk_layout(
        a, q, y, obs, rows, blocks_fn, dt, pinf, chunk, False)
    def block(bi):
        """(slice, A, Q) of block ``bi``, built again at each pass (the
        blocks-on-the-fly form keeps no (n, s, s) stack)."""
        sl = slice(bi * chunk, (bi + 1) * chunk)
        return (sl,) + _block_aq(a, q, dt, blocks_fn, pinf, bi, chunk, n, sl, False)

    with full_fp32():
        prev = _filter_identity(s, y.dtype, y.device)
        starts = []
        for bi in range(nc):
            sl, ab, qb = block(bi)
            starts.append(prev)
            fb = _block_feed(feed, payload, sl)
            full = _local_filter(prev, ab, qb, *_block_hr(h, r, rows, payload, fb),
                                 y[..., sl], obs[sl])
            prev = tuple(x[..., -1, :] if rk == 1 else x[..., -1, :, :]
                         for x, rk in zip(full, _FILTER_RANKS))
        suffix = (torch.eye(s, dtype=y.dtype, device=y.device),
                  torch.zeros(s, dtype=y.dtype, device=y.device),
                  torch.zeros((s, s), dtype=y.dtype, device=y.device))
        means, variances = [None] * nc, [None] * nc
        for bi in reversed(range(nc)):
            sl, ab, qb = block(bi)
            fb = _block_feed(feed, payload, sl)
            hb, rb = _block_hr(h, r, rows, payload, fb)
            full = _local_filter(starts[bi], ab, qb, hb, rb, y[..., sl], obs[sl])
            m_f, p_f = full[1], full[2]
            if bi + 1 < nc:
                # the next block's first row: a real row, never the global
                # first one nor a pad
                nxt = slice((bi + 1) * chunk, (bi + 1) * chunk + 1)
                an, qn = (a[..., nxt, :, :], q[..., nxt, :, :]) if blocks_fn is None \
                    else blocks_fn(dt[nxt])
            else:
                an = ab.new_zeros(ab.shape[:-3] + (1, s, s))
                qn = _eye(s, qb).expand(qb.shape[:-3] + (1, s, s))
            lead_a = torch.broadcast_shapes(ab.shape[:-3], an.shape[:-3])
            a_n = torch.cat([ab[..., 1:, :, :].expand(lead_a + (ab.shape[-3] - 1, s, s)),
                             an.expand(lead_a + (1, s, s))], dim=-3)
            lead_q = torch.broadcast_shapes(qb.shape[:-3], qn.shape[:-3])
            q_n = torch.cat([qb[..., 1:, :, :].expand(lead_q + (qb.shape[-3] - 1, s, s)),
                             qn.expand(lead_q + (1, s, s))], dim=-3)
            p_pred = _bmm(a_n, _bmm(p_f, _bt(a_n))) + q_n
            e_k = _bmm(p_f, _bmm(_bt(a_n), small_inv(p_pred)))
            g_k = m_f - _bmv(e_k, _bmv(a_n, m_f))
            l_k = p_f - _bmm(e_k, _bmm(p_pred, _bt(e_k)))
            suf = _smoother_scan((e_k, g_k, l_k))
            carry = (suffix[0][..., None, :, :], suffix[1][..., None, :],
                     suffix[2][..., None, :, :])
            total = _smoother_combine(carry, suf)
            hrow = hb.expand(torch.broadcast_shapes(hb.shape, total[1].shape))
            means[bi] = (total[1] * hrow).sum(dim=-1)
            variances[bi] = (_bmv(total[2], hrow) * hrow).sum(dim=-1)
            suffix = (total[0][..., 0, :, :], total[1][..., 0, :], total[2][..., 0, :, :])
    return torch.cat(means, dim=-1)[..., :n], torch.cat(variances, dim=-1)[..., :n]


# ---------------------------------------------------------------------------
# the time-axis-sharded programs (item 16)
# ---------------------------------------------------------------------------


def sharded_ssm_nll(*args, **kwargs):
    """Time-axis-sharded exact NLL over a device mesh (item 16)."""
    raise NotImplementedError(_NO_MESH)


def sharded_ssm_nll_multi(*args, **kwargs):
    """The per-row-emission form of :func:`sharded_ssm_nll` (item 16)."""
    raise NotImplementedError(_NO_MESH)


def sharded_ssm_nll_payload(*args, **kwargs):
    """The interpolated-emission form of :func:`sharded_ssm_nll` (item 16)."""
    raise NotImplementedError(_NO_MESH)


def sharded_ssm_laplace(*args, **kwargs):
    """The sharded Laplace NLL of the non-gaussian family (item 16)."""
    raise NotImplementedError(_NO_MESH)
