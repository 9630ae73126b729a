"""Gauss-Hermite quadrature for warped-process moments (the PyTorch
counterpart of :mod:`g3py_tpu.ops.quadrature`): ``E[f(X)]`` for
``X ~ N(mu, sigma^2)`` with an n-point Hermite rule, one vectorized ``f``
call over the whole (n, len(mu)) grid — (R, n, len(mu)) for (R, m) moments
of R hyperparameter rows, so ``f`` sees the row axis first."""

import math

import numpy as np
import torch

__all__ = ["gauss_hermite", "hermgauss", "hermite_grid", "hermite_moments"]


def hermgauss(n, dtype=torch.float32, device="cpu"):
    """Hermite nodes and weights as tensors."""
    a, w = np.polynomial.hermite.hermgauss(n)
    return (torch.as_tensor(a, dtype=dtype, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


def hermite_grid(mu, sigma, n=10):
    """``(grid, w)``: the n-point rule's nodes for N(mu, sigma^2),
    ``grid[..., j, i] = mu[..., i] + sqrt(2) sigma[..., i] a[j]``, and its
    weights; E[f(X)] = w @ f(grid) / sqrt(pi)."""
    a, w = hermgauss(n, mu.dtype, mu.device)
    return mu[..., None, :] + math.sqrt(2.0) * sigma[..., None, :] * a[:, None], w


def gauss_hermite(f, mu, sigma, n=10):
    """E[f(X)], X ~ N(mu, sigma^2), elementwise over mu/sigma vectors (or
    (R, m) matrices, one row per hyperparameter row):
    ``w @ f(grid) / sqrt(pi)`` over :func:`hermite_grid`."""
    grid, w = hermite_grid(mu, sigma, n)
    return torch.matmul(w, f(grid)) / math.sqrt(math.pi)


def hermite_moments(f, mu, sigma, n=10):
    """(E[f(X)], Var[f(X)]), X ~ N(mu, sigma^2), from one evaluation of f on
    the grid.  The variance is the centred second moment E[(f - E f)^2]:
    E[f^2] - E[f]^2 cancels where the variance is ~eps f^2 (at the observed
    points of a near-noiseless warped process) and goes negative in
    float32."""
    grid, w = hermite_grid(mu, sigma, n)
    t = f(grid)
    m1 = torch.matmul(w, t) / math.sqrt(math.pi)
    dev = t - m1[..., None, :]
    return m1, torch.matmul(w, dev * dev) / math.sqrt(math.pi)
