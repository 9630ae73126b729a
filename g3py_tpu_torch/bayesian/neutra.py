"""Neural-transport (NeuTra) reparameterization for NUTS (the PyTorch
counterpart of :mod:`g3py_tpu.bayesian.neutra`; Hoffman et al. 2019).

    theta = f(z) = mean + L couplings(z)
    logp_tilde(z) = logp(f(z)) + log|det df/dz|

The flow is an ``nn.Module`` (:class:`Flow`): a fixed whitening layer (the
draws' mean and covariance Cholesky) after ``n_couplings`` RealNVP affine
half-mask couplings with small tanh MLPs whose last layers start at zero, so
the flow starts as the whitening transport.  It is fitted by maximum
likelihood to posterior draws (ensemble warmup) with a full-batch Adam
written out as the JAX package writes it; NUTS then runs in the latent
space, and the pullback density's gradient reaches the model's rows'
batched gradient through the flow's Jacobian (torch autograd).
"""

import math

import numpy as np
import torch
from torch import nn

from ..config import settings
from .samplers import _generator

__all__ = ["Flow", "init_flow", "fit_flow", "flow_forward", "flow_inverse", "neutra_logp",
           "neutra_nuts"]

_S_MAX = 4.0  # tanh bound on coupling log-scales (numerical safety)


def _make_masks(ndim, n_couplings):
    """Alternating even/odd binary masks, one per coupling layer."""
    if n_couplings == 0:
        return np.zeros((0, ndim), np.float32)
    base = (np.arange(ndim) % 2).astype(np.float32)
    return np.stack([base if k % 2 == 0 else 1.0 - base for k in range(n_couplings)])


class Coupling(nn.Module):
    """One coupling MLP: ndim -> hidden (tanh) -> 2 ndim (log-scale || shift)."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)

    def forward(self, h_masked):
        hdn = torch.tanh(h_masked @ self.w1 + self.b1)
        out = hdn @ self.w2 + self.b2
        ndim = out.shape[-1] // 2
        return _S_MAX * torch.tanh(out[..., :ndim] / _S_MAX), out[..., ndim:]


class Flow(nn.Module):
    """The transport: buffers ``mean`` (ndim,), ``chol`` (ndim, ndim) and
    ``masks`` (n_couplings, ndim), and the ``layers``' parameters.  Calling
    it maps latent rows to ``(theta, log|det df/dz|)``
    (:func:`flow_forward`)."""

    def __init__(self, mean, chol, masks, layers):
        super().__init__()
        self.register_buffer("mean", mean)
        self.register_buffer("chol", chol)
        self.register_buffer("masks", masks)
        self.layers = nn.ModuleList(layers)

    def forward(self, z):
        return flow_forward(self, z)


def _tensor(a, dtype=None):
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    return torch.as_tensor(a, dtype=dtype or settings.dtype, device=settings.device)


def init_flow(ndim, draws=None, n_couplings=4, hidden=32, key=None, dtype=None):
    """A :class:`Flow` whose whitening layer is the (m, ndim) ``draws``'
    sample mean and regularized covariance Cholesky (the identity without
    draws); each coupling's first layer is N(0, 1/ndim) from a
    ``torch.Generator`` seeded by ``key``, its last layer zero."""
    dtype = dtype or settings.dtype
    if draws is not None:
        draws = _tensor(draws, dtype)
        mean = draws.mean(dim=0)
        centered = draws - mean
        cov = (centered.T @ centered) / max(draws.shape[0] - 1, 1)
        reg = 1e-6 * (torch.trace(cov) / ndim + 1e-12)
        chol, info = torch.linalg.cholesky_ex(cov + reg * torch.eye(ndim, dtype=dtype,
                                                                     device=cov.device))
        # failed or non-finite (degenerate draws) -> fall back to diagonal scales
        diag = torch.diag(torch.sqrt(torch.clamp(torch.diagonal(cov), min=1e-12)))
        chol = torch.where((info == 0) & torch.isfinite(chol).all(), chol, diag)
    else:
        mean = torch.zeros(ndim, dtype=dtype, device=settings.device)
        chol = torch.eye(ndim, dtype=dtype, device=settings.device)
    gen = _generator(key, mean.device)
    layers = [Coupling(torch.randn((ndim, hidden), generator=gen, dtype=dtype,
                                   device=mean.device) / math.sqrt(ndim),
                       mean.new_zeros(hidden), mean.new_zeros((hidden, 2 * ndim)),
                       mean.new_zeros(2 * ndim))
              for _ in range(n_couplings)]
    return Flow(mean, chol, _tensor(_make_masks(ndim, n_couplings), dtype), layers)


def flow_forward(params, z):
    """z (latent, (..., ndim)) -> (theta, log|det df/dz|); couplings first,
    whitening last."""
    h = z
    logdet = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    for layer, mask in zip(params.layers, params.masks):
        s, t = layer(h * mask)
        keep = 1.0 - mask
        h = mask * h + keep * (h * torch.exp(s) + t)
        logdet = logdet + (keep * s).sum(dim=-1)
    theta = params.mean + h @ params.chol.T
    return theta, logdet + torch.log(torch.diagonal(params.chol)).sum()


def flow_inverse(params, theta):
    """theta -> (z, log|det dz/dtheta|), the exact inverse of
    :func:`flow_forward`."""
    centered = (theta - params.mean).reshape(-1, theta.shape[-1])
    h = torch.linalg.solve_triangular(params.chol, centered.T, upper=False).T
    h = h.reshape(theta.shape)
    logdet = (-torch.log(torch.diagonal(params.chol)).sum()).expand(theta.shape[:-1])
    for layer, mask in zip(reversed(params.layers), reversed(list(params.masks))):
        s, t = layer(h * mask)
        keep = 1.0 - mask
        h = mask * h + keep * ((h - t) * torch.exp(-s))
        logdet = logdet - (keep * s).sum(dim=-1)
    return h, logdet


def _nll(params, draws):
    """Mean negative log-likelihood of draws under the push-forward of
    N(0, I)."""
    z, logdet_inv = flow_inverse(params, draws)
    d = draws.shape[-1]
    return ((0.5 * (z * z).sum(dim=-1) - logdet_inv).mean()
            + 0.5 * d * math.log(2.0 * math.pi))


def _fit(params, draws, steps, lr):
    """Full-batch Adam (b1 0.9, b2 0.999, eps 1e-8) on the couplings'
    parameters in place (the whitening stays fixed); returns the per-step
    NLL trace, a tensor."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    weights = list(params.layers.parameters())
    m = [torch.zeros_like(w) for w in weights]
    v = [torch.zeros_like(w) for w in weights]
    losses = draws.new_empty(int(steps))
    for i in range(int(steps)):
        with torch.enable_grad():
            for w in weights:
                w.requires_grad_(True)
            loss = _nll(params, draws)
            grads = torch.autograd.grad(loss, weights)
        losses[i] = loss.detach()
        t = float(i) + 1.0
        with torch.no_grad():
            for w, g, mk, vk in zip(weights, grads, m, v):
                mk.mul_(b1).add_((1 - b1) * g)
                vk.mul_(b2).add_((1 - b2) * g * g)
                w.sub_(lr * (mk / (1 - b1 ** t)) / (torch.sqrt(vk / (1 - b2 ** t)) + eps))
    params.requires_grad_(False)
    return losses


def fit_flow(draws, n_couplings=4, hidden=32, steps=1000, lr=1e-2, key=None):
    """Fit the transport to (m, ndim) posterior draws by maximum
    likelihood; returns ``(flow, losses)`` — the :class:`Flow` (its
    parameters frozen) and the per-step NLL trace on the host."""
    draws = _tensor(draws)
    flow = init_flow(draws.shape[-1], draws=draws, n_couplings=n_couplings, hidden=hidden,
                     key=key)
    if n_couplings == 0 or steps == 0:
        flow.requires_grad_(False)
        return flow, np.zeros((0,), settings.floatx)
    return flow, _fit(flow, draws, steps, lr).cpu().numpy()


def neutra_logp(logp, flow_params):
    """Pullback density logp_tilde(z) = logp(f(z)) + log|det df/dz|, batched
    and differentiable by torch autograd as ``logp`` is."""

    def logp_tilde(z):
        theta, logdet = flow_forward(flow_params, z)
        return logp(theta) + logdet

    return logp_tilde


def _start_draws(gen, m, chains, device):
    """The indices of the ``chains`` draws (of ``m``, without replacement)
    whose latent images start the chains."""
    return torch.randperm(m, generator=gen, device=device)[:chains]


def neutra_nuts(logp, draws, samples, chains=4, warmup=200, key=None, max_depth=8,
                target_accept=0.8, n_couplings=4, hidden=32, fit_steps=1000, fit_lr=1e-2,
                adapt_mass=True, flow=None):
    """NUTS through a transport fitted to ``draws``: fit the flow, start
    each chain at the latent image of a random draw, run the warmup and
    NUTS in latent space and map the chain back.  ``logp`` and ``key`` as in
    :func:`~g3py_tpu_torch.bayesian.nuts.nuts_sampler` (one generator
    serves the fit's initialization, the starts and the sampler).  A
    ``flow`` already fitted to ``draws`` (:func:`fit_flow`'s) is used as it
    is, with no fit.

    Returns (chain (chains, samples, ndim) in the original space, lnprob
    (chains, samples) of the original-space density, info with the NUTS
    diagnostics and ``fit_nll``, the flow's final training NLL, NaN for a
    given ``flow``)."""
    from .nuts import nuts_sampler

    dev = torch.device(settings.device)
    gen = _generator(key, dev)
    draws = _tensor(draws)
    losses = []
    if flow is None:
        flow, losses = fit_flow(draws, n_couplings=n_couplings, hidden=hidden,
                                steps=fit_steps, lr=fit_lr, key=gen)
    idx = _start_draws(gen, draws.shape[0], chains, dev)
    with torch.no_grad():
        z0, _ = flow_inverse(flow, draws[idx])
    zchain, zlnprob, info = nuts_sampler(
        neutra_logp(logp, flow), z0.cpu().numpy(), samples, warmup=warmup, key=gen,
        max_depth=max_depth, chains=chains, adapt_mass=adapt_mass,
        target_accept=target_accept)
    with torch.no_grad():
        theta, logdet = flow_forward(flow, _tensor(zchain))
    lnprob = zlnprob - logdet.cpu().numpy()
    info = dict(info)
    info["fit_nll"] = float(losses[-1]) if len(losses) else float("nan")
    return theta.cpu().numpy(), lnprob, info
