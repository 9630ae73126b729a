"""Ensemble MCMC samplers over the flat unconstrained hyperparameter vector
(the PyTorch counterpart of :mod:`g3py_tpu.bayesian.samplers`, subset).

* :func:`ensemble_sampler` — the Goodman & Weare (2010) stretch move with
  emcee's two-half update scheme;
* :func:`pt_sampler` — parallel tempering: the stretch move at every
  temperature of a ladder, then adjacent-temperature swaps;
* :func:`hmc_sampler` — leapfrog HMC, every chain in one batched
  value-and-gradient evaluation a leapfrog step;
* :func:`mcmc_ensemble` — the reference's entry point: jitter a start into an
  initial ensemble, run the (tempered) sampler, return ``(lnprob, chain)``.

The JAX package runs the chain as one ``lax.scan`` with the log density
``vmap``-ped over walkers.  Here the iteration loop runs on the host and
everything inside it stays on the device: the draws (a
``torch.Generator`` on ``settings.device`` seeded from ``key``), ONE
batched log-density call per half-ensemble — the rows of every walker
(and every temperature) of the half go through the batched kernels
together, so a chain of ``samples`` iterations makes ``1 + 2 * samples``
calls whatever the number of walkers — and accept/reject.  Nothing waits
for the device except what the log density itself waits for.

Each log density here maps an (R, ndim) tensor of rows to an (R,) tensor;
the gradient samplers (HMC here, NUTS, ADVI, the L-BFGS engine) also
differentiate it with torch autograd (:func:`value_and_grad`: the model's
sampling log densities make one batched value-and-gradient evaluation
for the forward and the backward together).  The draws of a half-ensemble
come from :func:`_half_draws`, the swap draws from :func:`_swap_draws` and
HMC's from :func:`_hmc_draws`; a test can replace them to feed the JAX
package's draws (the two generators give different numbers).
"""

import numpy as np
import torch

from ..config import settings

__all__ = ["ensemble_sampler", "pt_sampler", "default_beta_ladder", "hmc_sampler",
           "mcmc_ensemble", "value_and_grad"]


def value_and_grad(logp, z):
    """``(logp(z), d logp / dz)`` of a batched log density at the (R, ndim)
    rows ``z``, both detached; ``value_and_grad.calls`` counts the calls
    (each is one batched evaluation of a model's log density)."""
    value_and_grad.calls += 1
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        v = logp(z)
        grad = None
        if v.requires_grad:
            (grad,) = torch.autograd.grad(v.sum(), z, allow_unused=True)
    if grad is None:  # a density that does not depend on z
        grad = torch.zeros_like(z)
    return v.detach(), grad


value_and_grad.calls = 0


def _half_draws(gen, shape, n_other, dtype, device):
    """The draws of one half-ensemble update: the stretch variate ``u`` in
    [0, 1), the partner index ``j`` in the other half and ``log u`` of the
    acceptance test, each of ``shape`` (walkers, or temperatures x
    walkers)."""
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    j = torch.randint(0, n_other, shape, generator=gen, device=device)
    log_u = torch.log(torch.rand(shape, generator=gen, dtype=dtype, device=device))
    return u, j, log_u


def _swap_draws(gen, shape, dtype, device):
    """``log u`` of the adjacent-temperature swaps: (ntemps - 1, chains),
    row ``t_rev`` for the pair (T-1-t_rev, T-2-t_rev)."""
    return torch.log(torch.rand(shape, generator=gen, dtype=dtype, device=device))


def _safe(v):
    return torch.where(torch.isfinite(v), v, torch.full_like(v, -torch.inf))


def _stretch_half(gen, x_move, lp_move, aux_move, x_other, logp_rows, a):
    """Update one half of the ensemble against the complementary half
    (emcee semantics), for any leading axes (temperatures).  ``logp_rows``
    maps the proposals to ``(lp, aux)``: their log density and the
    per-walker values carried along with it (the tempered sampler's
    loglike and logprior)."""
    lead = x_move.shape[:-2]
    n, ndim = x_move.shape[-2:]
    u, j, log_u = _half_draws(gen, lead + (n,), x_other.shape[-2], x_move.dtype,
                              x_move.device)
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partner = torch.gather(x_other, -2, j[..., None].expand(lead + (n, ndim)))
    y = partner + z[..., None] * (x_move - partner)
    lp_y, aux_y = logp_rows(y)
    log_accept = (ndim - 1) * torch.log(z) + lp_y - lp_move
    accept = log_u < log_accept
    x_new = torch.where(accept[..., None], y, x_move)
    lp_new = torch.where(accept, lp_y, lp_move)
    aux_new = tuple(torch.where(accept, ay, am) for ay, am in zip(aux_y, aux_move))
    return x_new, lp_new, aux_new


def _ensemble_step(gen, x, lp, aux, logp_rows, a):
    """Both halves of one iteration; returns the new state."""
    half = x.shape[-2] // 2
    sl = (slice(None, half), slice(half, None))
    x1, lp1, aux1 = _stretch_half(gen, x[..., sl[0], :], lp[..., sl[0]],
                                  tuple(v[..., sl[0]] for v in aux), x[..., sl[1], :],
                                  logp_rows, a)
    x2, lp2, aux2 = _stretch_half(gen, x[..., sl[1], :], lp[..., sl[1]],
                                  tuple(v[..., sl[1]] for v in aux), x1, logp_rows, a)
    return (torch.cat([x1, x2], dim=-2), torch.cat([lp1, lp2], dim=-1),
            tuple(torch.cat(pair, dim=-1) for pair in zip(aux1, aux2)))


def _generator(key, device):
    """The draws' generator: ``key`` is an int seed (None: 0) or a
    ``torch.Generator`` on ``device`` (the JAX package takes a PRNG key or
    an int there)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(0 if key is None else int(key))


def _start(p0):
    p0 = torch.as_tensor(np.asarray(p0), dtype=settings.dtype, device=settings.device)
    if p0.shape[-2] % 2:
        raise ValueError("chains must be even for the two-half stretch move")
    return p0


def _chain_starts(z0, chains):
    """The (chains, ndim) starting rows of a gradient sampler on
    ``settings.device``: ``z0`` (ndim,) repeated ``chains`` times, or
    (chains, ndim) as given."""
    z0 = torch.as_tensor(np.asarray(z0), dtype=settings.dtype, device=settings.device)
    if z0.ndim == 1:
        z0 = z0[None, :].expand(chains, -1)
    return z0.contiguous()


def _finish(chain, lnprob):
    """(samples, chains, ...) device tensors -> host arrays in emcee's
    (chains, samples, ...) layout."""
    return chain.transpose(0, 1).cpu().numpy(), lnprob.T.cpu().numpy()


def ensemble_sampler(logp, p0, samples, key=None, a=2.0, shard=False):
    """Affine-invariant ensemble sampler.

    Args:
      logp: batched log density, (R, ndim) tensor -> (R,) tensor.
      p0: (chains, ndim) initial walkers (chains must be even).
      samples: iterations.
      key: int seed of the ``torch.Generator`` on ``settings.device``, or
        that generator.
      a: stretch scale (emcee default 2).
      shard: accepted; one card holds every walker.

    Returns host arrays ``chain (chains, samples, ndim)`` and ``lnprob
    (chains, samples)``."""
    x = _start(p0)
    gen = _generator(key, x.device)

    def logp_rows(y):
        return _safe(logp(y)), ()

    lp, _ = logp_rows(x)
    chain = torch.empty((samples,) + x.shape, dtype=x.dtype, device=x.device)
    lnprob = torch.empty((samples, x.shape[0]), dtype=x.dtype, device=x.device)
    for it in range(samples):
        x, lp, _ = _ensemble_step(gen, x, lp, (), logp_rows, a)
        chain[it], lnprob[it] = x, lp
    return _finish(chain, lnprob)


def default_beta_ladder(ntemps):
    """Geometric inverse-temperature ladder beta_t = 2^(-t/2)."""
    return 0.5 ** (0.5 * np.arange(ntemps))


def _swap(x, like, prior, betas, log_u):
    """Adjacent-temperature exchange, highest-to-lowest (the PTSampler
    recipe): accept with (beta_{t-1} - beta_t)(L_t - L_{t-1})."""
    ntemps = x.shape[0]
    for t_rev in range(ntemps - 1):
        t = ntemps - 1 - t_rev
        log_alpha = (betas[t - 1] - betas[t]) * (like[t] - like[t - 1])
        acc = log_u[t_rev] < log_alpha
        for v, w in ((x, acc[:, None]), (like, acc), (prior, acc)):
            hi, lo = v[t].clone(), v[t - 1].clone()
            v[t] = torch.where(w, lo, hi)
            v[t - 1] = torch.where(w, hi, lo)


def pt_sampler(loglike, logprior, p0, samples, betas=None, key=None, a=2.0, shard=False):
    """Parallel-tempered ensemble sampler over p0 (ntemps, chains, ndim);
    ``loglike`` and ``logprior`` are batched ((R, ndim) -> (R,)).  Every
    temperature's half-ensemble goes into ONE batched call of each.
    ``key`` as in :func:`ensemble_sampler`; ``shard`` is accepted.
    Returns the temperature-0 chain (reference kept ``lnprob[0],
    chain[0]``) and its lnprob."""
    x = _start(p0)
    ntemps, chains, ndim = x.shape
    gen = _generator(key, x.device)
    if betas is None:
        betas = default_beta_ladder(ntemps)
    betas = torch.as_tensor(np.asarray(betas), dtype=x.dtype, device=x.device)

    def parts(y):  # (T, n, ndim) -> like, prior (T, n)
        flat = y.reshape(-1, ndim)
        return (_safe(loglike(flat)).reshape(y.shape[:-1]),
                _safe(logprior(flat)).reshape(y.shape[:-1]))

    def logp_rows(y):
        like, prior = parts(y)
        return betas[:, None] * like + prior, (like, prior)

    like, prior = parts(x)
    chain = torch.empty((samples, chains, ndim), dtype=x.dtype, device=x.device)
    lnprob = torch.empty((samples, chains), dtype=x.dtype, device=x.device)
    for it in range(samples):
        lp = betas[:, None] * like + prior
        x, _, (like, prior) = _ensemble_step(gen, x, lp, (like, prior), logp_rows, a)
        _swap(x, like, prior, betas, _swap_draws(gen, (ntemps - 1, chains), x.dtype, x.device))
        chain[it], lnprob[it] = x[0], like[0] + prior[0]
    return _finish(chain, lnprob)


def _hmc_draws(gen, shape, dtype, device):
    """The draws of one HMC step for (chains, ndim) ``shape``: the momentum
    normals and the uniform of the acceptance test, one a chain."""
    p = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    u = torch.rand(shape[:-1], generator=gen, dtype=dtype, device=device)
    return p, u


def hmc_sampler(logp, p0, samples, key=None, step_size=0.05, leapfrog_steps=10,
                chains=1):
    """Vanilla HMC over the unconstrained parameter vector, every chain at
    once: a leapfrog step is one batched value-and-gradient evaluation of
    all chains (the gradient at the current state is carried from the
    step before), so a run makes ``1 + samples * leapfrog_steps``.  As in
    the JAX package a non-finite logp reads as -inf (its gradient 0) and
    is rejected.  ``key`` as in :func:`ensemble_sampler`.  Returns host
    arrays ``chain (chains, samples, ndim)`` and ``lnprob (chains,
    samples)``."""
    q = _chain_starts(p0, chains)
    gen = _generator(key, q.device)

    def evaluate(x):
        v, g = value_and_grad(logp, x)
        finite = torch.isfinite(v)
        return (torch.where(finite, v, torch.full_like(v, -torch.inf)),
                torch.where(finite[:, None], g, torch.zeros_like(g)))

    lq, gq = evaluate(q)
    chain = torch.empty((samples,) + q.shape, dtype=q.dtype, device=q.device)
    lnprob = torch.empty((samples, q.shape[0]), dtype=q.dtype, device=q.device)
    for it in range(samples):
        p, u = _hmc_draws(gen, q.shape, q.dtype, q.device)
        x, r, g = q, p + 0.5 * step_size * gq, gq
        for step in range(leapfrog_steps):
            x = x + step_size * r
            lx, g = evaluate(x)
            r = r + (0.5 if step == leapfrog_steps - 1 else 1.0) * step_size * g
        log_accept = lx - lq - 0.5 * ((r * r).sum(-1) - (p * p).sum(-1))
        accept = torch.log(u) < log_accept
        q = torch.where(accept[:, None], x, q)
        lq = torch.where(accept, lx, lq)
        gq = torch.where(accept[:, None], g, gq)
        chain[it], lnprob[it] = q, lq
    return _finish(chain, lnprob)


def mcmc_ensemble(ndim, samples=1000, chains=None, ntemps=None, start=None,
                  logp=None, loglike=None, logprior=None, noise_mult=0.1,
                  noise_sum=0.01, threads=1, parallel=False, seed=0):
    """The reference's entry point (``average.py:20-54``): jitter the start into an
    initial ensemble with ``np.random.default_rng(seed)`` (the same draws as
    the JAX package), run the (tempered) sampler, return ``(lnprob,
    chain)``.  ``threads`` and ``parallel`` are accepted and change nothing
    (the walkers of a half-ensemble share one batched call)."""
    if chains is None:
        chains = 2 * ndim
    chains = int(chains)
    if chains % 2:
        chains += 1
    rng = np.random.default_rng(seed)
    start = np.asarray(start, dtype=settings.floatx)

    if ntemps is None:
        if start.ndim == 2 and start.shape == (chains, ndim):
            p0 = start.copy()
        else:
            noise = rng.normal(loc=1, scale=noise_mult, size=(chains, ndim))
            p0 = noise * np.ones((chains, 1)) * start
        p0 += (p0 == 0) * rng.normal(loc=0, scale=noise_sum, size=p0.shape)
        chain, lnprob = ensemble_sampler(logp, p0.astype(settings.floatx), samples,
                                         key=seed)
    else:
        ntemps = int(ntemps)
        if start.ndim == 3 and start.shape == (ntemps, chains, ndim):
            p0 = start.copy()
        elif start.ndim == 2 and start.shape == (chains, ndim):
            noise = rng.normal(loc=1, scale=noise_mult, size=(ntemps, chains, ndim))
            p0 = noise * np.ones((ntemps, 1, 1)) * start
        else:
            noise = rng.normal(loc=1, scale=noise_mult, size=(ntemps, chains, ndim))
            p0 = noise * np.ones((ntemps, chains, 1)) * start
        p0 += (p0 == 0) * rng.normal(loc=0, scale=noise_sum, size=p0.shape)
        chain, lnprob = pt_sampler(loglike, logprior, p0.astype(settings.floatx), samples,
                                   key=seed)
    return lnprob, chain
