"""Random Fourier features and prior paths of the stationary kernels (the
PyTorch counterpart of :mod:`g3py_tpu.ops.rff`), behind pathwise
(Matheron) posterior sampling (Wilson et al., ICML 2020):

    f*(s) = f_prior(s) + K_sX (K + sigma^2 I)^{-1} (y - f_prior(X) - eps)

with the prior path drawn once from a feature expansion of the kernel's
spectral density (Rahimi & Recht 2007):

    f_prior(x) = sqrt(2 var / F) cos(x W^T + b) theta,
    W ~ spectral density,  b ~ U(0, 2pi),  theta ~ N(0, I_F)

In the ARD_L2 parametrization (d = 0.5 |rate o delta|^2):

* SE  (k = var exp(-d)):   omega = z rate, z ~ N(0, I);
* Matern-nu (MAT32 nu=1.5, MAT52 nu=2.5): a multivariate t with 2 nu
  degrees of freedom at per-dim inverse lengthscale rate/sqrt(2),
  omega = z sqrt(2nu/u) rate/sqrt(2), u ~ chi^2_{2nu} = 2 Gamma(nu);
* RQ  (k = var (1 + d/alpha)^-alpha): a gamma scale mixture of SE,
  omega = z sqrt(g) rate, g ~ Gamma(alpha, rate=alpha).

The draws are kept apart from the transform: each function takes ``key``,
either a seed or a ``torch.Generator`` to draw from (on ``settings.device``),
or a dict of the draws themselves (:func:`draw_rff`'s keys ``z``, ``gamma``,
``b``, ``theta``), so that the same normals, gammas and phases give the
same features on any platform.
"""

import math

import numpy as np
import torch

from ..config import settings

__all__ = ["draw_rff", "spectral_rff", "se_spectral_rff", "rff_prior_fn", "standard_gamma"]


def _generator(key):
    """A ``torch.Generator`` on ``settings.device``: ``key`` itself, or
    one seeded with the int ``key``."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=settings.device)
    gen.manual_seed(int(key))
    return gen


def standard_gamma(gen, shape_param, size, dtype=None, tries=16):
    """Gamma(shape_param, 1) draws of ``size`` from ``gen`` (Marsaglia and
    Tsang's squeeze on normal and uniform draws, ``tries`` proposals per
    draw, a shape below 1 boosted by U^(1/shape)): torch's own gamma
    sampler takes no generator."""
    dtype = settings.dtype if dtype is None else dtype
    a = torch.as_tensor(shape_param, dtype=dtype, device=settings.device)
    boost = a < 1.0
    a1 = torch.where(boost, a + 1.0, a)
    d = a1 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    x = torch.randn((tries,) + tuple(size), generator=gen, dtype=dtype, device=settings.device)
    u = torch.rand((tries,) + tuple(size), generator=gen, dtype=dtype, device=settings.device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(
        torch.clamp(v, min=1e-30)))
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
    out = torch.gather(d * v, 0, first)[0]
    ub = torch.rand(tuple(size), generator=gen, dtype=dtype, device=settings.device)
    return torch.where(boost, out * ub ** (1.0 / a), out)


def draw_rff(key, ndim, n_features, n_paths=None, nu=None, rq_alpha=None):
    """The draws of one feature expansion from ``key`` (a seed or a
    ``torch.Generator``): ``z`` (F, ndim) standard normals, ``gamma`` (F,)
    standard-gamma draws (Gamma(nu) for a Matern, Gamma(alpha) for the
    RQ; absent for the SE), the phases ``b`` (F,) on [0, 2pi) and, with
    ``n_paths``, the path weights ``theta`` (F, n_paths)."""
    gen = _generator(key)
    dt, dev = settings.dtype, settings.device
    draws = {"z": torch.randn((n_features, ndim), generator=gen, dtype=dt, device=dev)}
    if rq_alpha is not None:
        draws["gamma"] = standard_gamma(gen, rq_alpha, (n_features,))
    elif nu is not None:
        draws["gamma"] = standard_gamma(gen, nu, (n_features,))
    draws["b"] = 2.0 * math.pi * torch.rand((n_features,), generator=gen, dtype=dt, device=dev)
    if n_paths is not None:
        draws["theta"] = torch.randn((n_features, n_paths), generator=gen, dtype=dt,
                                     device=dev)
    return draws


def _as_draws(key, ndim, n_features, n_paths=None, nu=None, rq_alpha=None):
    if isinstance(key, dict):
        return {k: torch.as_tensor(np.array(v) if isinstance(v, np.ndarray) else v,
                                   dtype=settings.dtype, device=settings.device)
                for k, v in key.items()}
    return draw_rff(key, ndim, n_features, n_paths, nu=nu, rq_alpha=rq_alpha)


def _frequencies(draws, ndim, rates, nu=None, rq_alpha=None):
    """Spectral frequencies (F, ndim) from the draws (module docstring)."""
    rates = torch.broadcast_to(torch.as_tensor(rates, dtype=settings.dtype,
                                               device=settings.device), (ndim,))
    z = draws["z"]
    if rq_alpha is not None:  # RQ: gamma scale mixture of SE
        alpha = torch.as_tensor(rq_alpha, dtype=settings.dtype, device=settings.device)
        g = draws["gamma"] / torch.clamp(alpha, min=1e-12)
        return z * torch.sqrt(torch.clamp(g, min=1e-12))[:, None] * rates[None, :]
    if nu is None:  # SE
        return z * rates[None, :]
    df = 2.0 * nu
    u = 2.0 * draws["gamma"]  # chi^2_{2nu}
    t_scale = torch.sqrt(df / torch.clamp(u, min=1e-12))
    return z * t_scale[:, None] * (rates[None, :] / math.sqrt(2.0))


def spectral_rff(key, ndim, n_features, rates, var, nu=None, rq_alpha=None):
    """Feature map ``phi(x) -> (len(x), n_features)`` with ``phi(x)
    phi(y)^T -> k(x, y)`` as ``n_features`` grows; ``nu=None`` for the SE,
    1.5/2.5 for MAT32/MAT52, ``rq_alpha`` for the rational quadratic.
    ``key`` is a seed, a ``torch.Generator`` or a dict of draws."""
    draws = _as_draws(key, ndim, n_features, nu=nu, rq_alpha=rq_alpha)
    w = _frequencies(draws, ndim, rates, nu=nu, rq_alpha=rq_alpha)
    b = draws["b"]
    scale = torch.sqrt(2.0 * torch.as_tensor(var, dtype=settings.dtype,
                                             device=settings.device) / n_features)

    def phi(x):
        x = torch.as_tensor(x, dtype=settings.dtype, device=settings.device)
        return scale * torch.cos(torch.matmul(x, w.T) + b[None, :])

    return phi


def se_spectral_rff(key, ndim, n_features, rates, var):
    """SE-only alias of :func:`spectral_rff`."""
    return spectral_rff(key, ndim, n_features, rates, var, nu=None)


def rff_prior_fn(key, ndim, n_features, rates, var, n_paths, nu=None, rq_alpha=None):
    """``prior(x) -> (len(x), n_paths)`` zero-mean prior paths from the
    feature expansion: one global function per path, so evaluations at
    the training set and at any query batch are consistent joint draws,
    as Matheron's update needs.  ``key`` is a seed, a ``torch.Generator``
    or a dict of draws (with ``theta``)."""
    draws = _as_draws(key, ndim, n_features, n_paths, nu=nu, rq_alpha=rq_alpha)
    phi = spectral_rff(draws, ndim, n_features, rates, var, nu=nu, rq_alpha=rq_alpha)
    theta = draws["theta"]

    def prior(x):
        return torch.matmul(phi(x), theta)

    return prior
