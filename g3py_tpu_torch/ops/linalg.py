"""Robust dense linear algebra, forward only (the PyTorch counterpart of
:mod:`g3py_tpu.ops.linalg`).

* :func:`safe_cholesky` keeps the ``CholeskyRobust`` contract: never raise;
  one clean factorization, then a one-time repair of a non-positive
  diagonal plus escalating jitter ``mean(diag) * 1e-6 * 10**(k-1)`` for a
  bounded number of tries, and ``1e-10 * I`` on total failure.  Failure is
  read from ``torch.linalg.cholesky_ex``'s info (XLA signals it with NaNs;
  torch does not), together with a finiteness check of the factor.
* :func:`mvn_quad_logdet` returns ``(quad, logdet_half, ok)`` of a gaussian
  quadratic form through that factorization.
* Triangular solves are ``torch.linalg.solve_triangular``.  The JAX
  package's ``blocked_*`` routines work around the TPU's slow triangular
  solve and have no counterpart here.
"""

import torch

from ..config import settings

__all__ = ["safe_cholesky", "solve_lower_triangular", "cho_solve",
           "log_det_from_chol", "mvn_quad_logdet"]


def _try_cholesky(a):
    chol, info = torch.linalg.cholesky_ex(a)
    ok = bool((info == 0) & torch.isfinite(chol).all())
    return chol, ok


def _safe_cholesky_impl(a, max_tries):
    """Escalating-jitter factorization; returns ``(L, failed)``.  The common
    case costs one Cholesky and one host sync (reading the info flag)."""
    chol, ok = _try_cholesky(a)
    if ok:
        return chol, False
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    with torch.no_grad():
        diag = torch.diagonal(a)
        base = diag.mean() * settings.cholesky_jitter
        dmin = diag.min()
        # the non-positive diagonal is fixed once, before the escalation
        diag_fix = torch.where(dmin <= 0.0, base - dmin, torch.zeros_like(dmin))
    for k in range(1, max_tries):
        chol, ok = _try_cholesky(a + (diag_fix + base * 10.0 ** (k - 1)) * eye)
        if ok:
            return chol, False
    return 1e-10 * eye, True


def safe_cholesky(a, max_tries=None):
    """Lower-triangular Cholesky that never fails.

    try 0:   ``cholesky(a)``
    try k>0: ``cholesky(a + diag_fix + mean(diag)*1e-6*10**(k-1) * I)`` where
             ``diag_fix`` lifts a non-positive diagonal to ``mean(diag)*1e-6``
    failure: ``1e-10 * I`` after ``max_tries`` attempts in all
             (``settings.cholesky_max_tries`` by default).
    """
    if max_tries is None:
        max_tries = settings.cholesky_max_tries
    return _safe_cholesky_impl(a, max_tries)[0]


def solve_lower_triangular(chol, b):
    """L x = b for a vector or matrix right-hand side."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(chol, b[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(chol, b, upper=False)


def cho_solve(chol, b):
    """(L L^T)^{-1} b from the lower factor."""
    y = solve_lower_triangular(chol, b)
    if y.ndim == 1:
        return torch.linalg.solve_triangular(chol.T, y[:, None], upper=True)[:, 0]
    return torch.linalg.solve_triangular(chol.T, y, upper=True)


def log_det_from_chol(chol):
    """log det(A) = 2 * sum(log diag L)."""
    return 2.0 * torch.log(torch.diagonal(chol)).sum()


def mvn_quad_logdet(k, resid, max_tries=None):
    """``(quad, logdet_half, ok)`` for a gaussian quadratic form:

      quad        = resid^T K^{-1} resid
      logdet_half = sum log diag chol(K)  (= 1/2 log det K)
      ok          = 0.0 when the robust factorization fell back, else 1.0

    Forward only: the analytic-gradient backward of the JAX package comes
    with training."""
    if max_tries is None:
        max_tries = settings.cholesky_max_tries
    chol, failed = _safe_cholesky_impl(k, max_tries)
    z = solve_lower_triangular(chol, resid)
    quad = torch.dot(z, z)
    logdet_half = torch.log(torch.diagonal(chol)).sum()
    ok = torch.tensor(0.0 if failed else 1.0, dtype=k.dtype, device=k.device)
    return quad, logdet_half, ok
