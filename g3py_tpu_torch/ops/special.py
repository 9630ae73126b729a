"""Special functions of the Student-t, marginal and copula families (the
port's copy of what the JAX package takes from ``jax.scipy.special`` and
``jax.scipy.stats.norm``).

* :func:`gammaln` and :func:`ndtri` are torch's own (``torch.lgamma``,
  ``torch.special``); :func:`ndtr` is the JAX package's two-tailed
  erf/erfc form (torch's cancels in the lower tail); :func:`norm_cdf` is
  the normal CDF with a location and a scale.
* :func:`betainc` is the regularized incomplete beta I_x(a, b), which torch
  lacks: the continued fraction of DLMF 8.17.23 by the modified Lentz
  method, with the symmetry swap of DLMF 8.17.4 where x > (a+1)/(a+b+2),
  as the JAX package evaluates it (the same partial numerators, tolerance
  and iteration cap: 200 in float32, 600 in float64).  All elements run
  until every one has converged; the convergence flag is read on the host
  every ``_CHECK_EVERY`` steps (one sync each), so a few steps may run past
  the point where the JAX loop stops.  Its gradient is in x only,
  x^(a-1) (1-x)^(b-1) / B(a, b); a gradient in a or b raises the JAX
  package's ``ValueError``.
"""

import math

import torch

__all__ = ["gammaln", "ndtri", "ndtr", "norm_cdf", "betaln", "betainc"]

_CHECK_EVERY = 8


def gammaln(x):
    """log|Gamma(x)|."""
    return torch.lgamma(x)


def ndtri(p):
    """The standard normal quantile function."""
    return torch.special.ndtri(p)


def ndtr(x):
    """The standard normal CDF, 0.5 (1 + erf(w)) for |w| < 1/sqrt(2) and
    0.5 erfc(|w|) (or 1 - 0.5 erfc(w)) beyond, w = x / sqrt(2) — the form
    of ``jax.scipy.special.ndtr`` (and scipy's), which keeps both tails.
    ``torch.special.ndtr`` takes 1 + erf throughout, which cancels in the
    lower tail: 2% off at x = -8 and 0 below -8.3 in float64, 4% off at
    x = -5 in float32."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def norm_cdf(x, loc=0.0, scale=1.0):
    """The normal CDF at ``x`` with location ``loc`` and scale ``scale``
    (``jax.scipy.stats.norm.cdf``)."""
    return ndtr((x - loc) / scale)


def betaln(a, b):
    """log B(a, b)."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _numerator(k, a, b, x):
    """The k-th partial numerator of DLMF 8.17.23 (k >= 1)."""
    if k == 1:
        return torch.ones_like(x)
    m = (k - 1) // 2
    if k % 2 == 0:
        if m == 0:
            return -(a + b) * x / (a + 1.0)
        return -(a + m) * (a + b + m) * x / ((a + 2.0 * m) * (a + 2.0 * m + 1.0))
    return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))


def _continued_fraction(a, b, x):
    """Lentz-Thompson-Barnett evaluation of the continued fraction; every
    element iterates until all have converged or the cap is reached."""
    finfo = torch.finfo(x.dtype)
    small = finfo.eps / 2
    threshold = finfo.eps / 2
    iterations = 200 if x.dtype == torch.float32 else 600
    # the zeroth partial denominator is 0, so h starts at ``small``
    h = torch.full_like(x, small)
    c = h
    d = torch.zeros_like(x)
    small_t = torch.full_like(x, small)
    for k in range(1, iterations):
        num = _numerator(k, a, b, x)
        c = 1.0 + num / c
        c = torch.where(c.abs() < small, small_t, c)
        d = 1.0 + num * d
        d = torch.where(d.abs() < small, small_t, d)
        d = 1.0 / d
        delta = c * d
        h = h * delta
        if k % _CHECK_EVERY == 0 and not bool(((delta - 1.0).abs() >= threshold).any()):
            break
    return h


def _betainc_value(a, b, x):
    a, b, x = torch.broadcast_tensors(a, b, x)
    a_zero = (a == 0) | (b == float("inf"))
    b_zero = (b == 0) | (a == float("inf"))
    x_zero, x_one = x == 0, x == 1
    result_zero = (b_zero & ~x_one) | (a_zero & x_zero)
    result_one = (a_zero & ~x_zero) | (b_zero & x_one)
    result_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero)
                  | torch.isnan(a) | torch.isnan(b) | torch.isnan(x))

    rapid = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(rapid, a, b), torch.where(rapid, b, a)
    x = torch.where(rapid, x, 1.0 - x)
    frac = _continued_fraction(a, b, x)
    very_small = torch.finfo(x.dtype).tiny * 2
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(a < very_small, torch.exp(torch.log1p(-x) * b - lbeta_small_a),
                         torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a)
    result = frac * factor
    result = torch.where(rapid, result, 1.0 - result)
    result = torch.where(result_zero, torch.zeros_like(result), result)
    result = torch.where(result_one, torch.ones_like(result), result)
    return torch.where(result_nan, torch.full_like(result, float("nan")), result)


class _Betainc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, x):
        ctx.save_for_backward(a, b, x)
        return _betainc_value(a, b, x)

    @staticmethod
    def backward(ctx, grad):
        a, b, x = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError("Betainc gradient with respect to a and b not supported.")
        partial_x = torch.exp((b - 1.0) * torch.log1p(-x) + (a - 1.0) * torch.log(x)
                              - betaln(a, b))
        gx = grad * partial_x
        # reduce over the axes that broadcasting added to x
        while gx.ndim > x.ndim:
            gx = gx.sum(dim=0)
        for i, size in enumerate(x.shape):
            if size == 1 and gx.shape[i] != 1:
                gx = gx.sum(dim=i, keepdim=True)
        return None, None, gx


def betainc(a, b, x):
    """The regularized incomplete beta function I_x(a, b), elementwise over
    broadcast tensors, differentiable in ``x`` only (see the module
    docstring)."""
    x = torch.as_tensor(x)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    return _Betainc.apply(a, b, x)
