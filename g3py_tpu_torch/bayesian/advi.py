"""Automatic Differentiation Variational Inference over the unconstrained
hyperparameter posterior (the PyTorch counterpart of
:mod:`g3py_tpu.bayesian.advi`): a Gaussian ``q(z) = N(mu, L L^T)``, mean
field or full rank, fitted by reparameterized-gradient ascent on

    ELBO(mu, L) = E_eps[logp(mu + L eps)] + sum_i log L_ii + ndim/2 (1 + log 2 pi).

A step draws ``mc`` normals ``eps`` (:func:`_elbo_draws`), evaluates the
log density and its gradient at the ``mc`` rows ``z = mu + eps L^T`` in one
batched call, and reaches the gradients of ``mu`` and ``L`` by the chain
rule (torch autograd through the rows).  The update is the JAX package's
``optax.chain(clip_by_global_norm(10), adam(exponential_decay(lr, steps,
0.05)))`` written out, and the last fifth of the iterates is averaged.
"""

import math

import numpy as np
import torch

from ..config import settings
from ..utils import DictObj
from .samplers import _generator, value_and_grad

__all__ = ["fit_advi", "advi_draws"]

_LOG2PI = math.log(2.0 * math.pi)


def _elbo_draws(gen, shape, dtype, device):
    """The ``(mc, ndim)`` standard normals of one ELBO step."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _draws(gen, shape, dtype, device):
    """The ``(chains, samples, ndim)`` standard normals of :func:`advi_draws`."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _unpack(theta, ndim, full_rank):
    """Variational params vector -> (mu, scale_tril, log of its diagonal)."""
    mu = theta[:ndim]
    log_d = theta[ndim:2 * ndim]
    chol = torch.diag_embed(torch.exp(log_d))
    if full_rank:
        chol = chol + torch.tril(theta[2 * ndim:].reshape(ndim, ndim), -1)
    return mu, chol, log_d


class _Adam:
    """``optax.adam(lr)`` written out as optax writes it (b1 0.9, b2 0.999,
    eps 1e-8, a constant rate) over one flat parameter vector: optax's
    update is elementwise, so a pytree of leaves is their concatenation."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, theta, lr):
        self.m = torch.zeros_like(theta)
        self.v = torch.zeros_like(theta)
        self.lr, self.count = float(lr), 0

    def _rate(self):
        return self.lr

    def step(self, theta, g):
        rate = self._rate()
        self.count += 1
        self.m = (1 - self.b1) * g + self.b1 * self.m
        self.v = (1 - self.b2) * (g * g) + self.b2 * self.v
        m_hat = self.m / (1 - self.b1 ** self.count)
        v_hat = self.v / (1 - self.b2 ** self.count)
        return theta - rate * (m_hat / (torch.sqrt(v_hat) + self.eps))


class _ClippedDecayAdam(_Adam):
    """``clip_by_global_norm(10)`` then Adam at the rate ``lr * 0.05 **
    (count / steps)`` (optax's ``exponential_decay``, continuous)."""

    max_norm = 10.0

    def __init__(self, theta, lr, steps):
        super().__init__(theta, lr)
        self.steps = int(steps)

    def _rate(self):
        # the rate in float32, as optax's schedule computes it whatever the
        # parameters' dtype (compiled, count / steps is count * (1 / steps))
        f32 = dict(dtype=torch.float32)
        return float(torch.tensor(self.lr, **f32) * torch.pow(
            torch.tensor(0.05, **f32),
            torch.tensor(self.count, **f32) * (torch.tensor(1.0, **f32) / self.steps)))

    def step(self, theta, g):
        norm = torch.sqrt((g * g).sum())
        g = torch.where(norm < self.max_norm, g, g / norm * self.max_norm)
        return super().step(theta, g)


def fit_advi(logp, z0, steps=2000, mc=8, lr=0.02, full_rank=True, seed=0, sigma0=0.1):
    """Fit a Gaussian variational approximation to ``exp(logp)``.

    ``logp`` is a batched log density that torch can differentiate ((R,
    ndim) -> (R,), the contract of the NUTS sampler); ``z0`` (ndim,)
    starts the variational mean (the MAP is a good start); ``mc`` normals a
    step; ``full_rank`` fits the full covariance Cholesky (False: mean
    field); ``seed`` seeds the ``torch.Generator`` of the normals on
    ``settings.device``.  Non-finite log densities read as -1e30 with a
    zero gradient, and non-finite gradients as 0.

    Returns ``DictObj(mu (ndim,), scale_tril (ndim, ndim), elbo (steps,),
    converged)`` on the host — the averaged iterate of the last fifth, the
    ELBO trace (each step's estimate before its update) and whether the
    last decile stopped improving (the JAX package's rule)."""
    z0 = torch.as_tensor(np.asarray(z0, settings.floatx).reshape(-1), device=settings.device)
    ndim = z0.shape[0]
    parts = [z0, torch.full((ndim,), math.log(sigma0), dtype=z0.dtype, device=z0.device)]
    if full_rank:
        parts.append(z0.new_zeros(ndim * ndim))
    theta = torch.cat(parts)
    gen = _generator(seed, z0.device)
    opt = _ClippedDecayAdam(theta, lr, steps)
    tail_start = int(steps) - max(int(steps) // 5, 1)
    acc, cnt = torch.zeros_like(theta), 0
    elbo = theta.new_empty(int(steps))
    for i in range(int(steps)):
        eps = _elbo_draws(gen, (int(mc), ndim), theta.dtype, theta.device)
        with torch.enable_grad():
            t = theta.detach().requires_grad_(True)
            mu, chol, log_d = _unpack(t, ndim, full_rank)
            z = mu[None, :] + eps @ chol.T
            lp, g_z = value_and_grad(logp, z)
            finite = torch.isfinite(lp)
            lp = torch.where(finite, lp, torch.full_like(lp, -1e30))
            g_z = torch.where(finite[:, None], g_z, torch.zeros_like(g_z))
            ent = log_d.sum() + 0.5 * ndim * (1.0 + _LOG2PI)
            val = -(lp.mean() + ent)
            (g,) = torch.autograd.grad(-(z * g_z).sum() / int(mc) - ent, t)
        elbo[i] = -val.detach()
        theta = opt.step(theta, torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0))
        if i >= tail_start:
            acc, cnt = acc + theta, cnt + 1
    theta = acc / max(cnt, 1)
    mu, chol, _ = _unpack(theta, ndim, full_rank)
    elbo = elbo.cpu().numpy()
    k = max(len(elbo) // 10, 1)
    tail, head = float(np.mean(elbo[-k:])), float(np.mean(elbo[:k]))
    scale = max(abs(tail - head), 1.0)
    prev = float(np.mean(elbo[-2 * k:-k])) if len(elbo) >= 2 * k else head
    converged = bool(tail - prev <= 1e-3 * scale + 1e-6) or (tail > prev - 1e-6)
    return DictObj(mu=mu.cpu().numpy(), scale_tril=chol.cpu().numpy(), elbo=elbo,
                   converged=converged)


def advi_draws(fit, chains, samples, seed=0):
    """iid draws from the fitted q, (chains, samples, ndim) on the host in
    ``settings.floatx`` — the ensemble/NUTS chain layout; the normals come
    from a ``torch.Generator`` on ``settings.device`` seeded by ``seed``."""
    mu = torch.as_tensor(np.asarray(fit.mu), dtype=settings.dtype, device=settings.device)
    chol = torch.as_tensor(np.asarray(fit.scale_tril), dtype=settings.dtype,
                           device=settings.device)
    eps = _draws(_generator(seed, mu.device), (int(chains), int(samples), mu.shape[0]),
                 mu.dtype, mu.device)
    return (mu + eps @ chol.T).cpu().numpy().astype(settings.floatx)
