"""Sharded computation wrappers over a mesh (the PyTorch counterpart of
:mod:`g3py_tpu.parallel.sharded`).

* :func:`sharded_logp_fn` — a process's posterior logp over the flat
  unconstrained vector with the data rows split over the ranks: each rank
  holds a band, and the logp gathers what the exact factor needs (the
  JAX package lets XLA insert that gather).
* :func:`sharded_ensemble_step` — one stretch-move iteration with the
  walker axis split over the ranks: a rank proposes and evaluates its own
  walkers of each half against the all-gathered complementary half.
* :func:`pt_sampler_sharded` — parallel tempering with one temperature a
  rank and a deterministic even-odd exchange between neighbours.

Every rank calls these with the same arguments (SPMD).  The draws come
from ``torch.Generator`` s seeded alike on every rank (so a split step
takes exactly the single-device step's draws) through
:func:`g3py_tpu_torch.bayesian.samplers._half_draws` and
:func:`_pair_uniform`, which a test can replace to feed the JAX package's
draws.
"""

import numpy as np
import torch

from ..config import settings, as_tensor
from .mesh import make_mesh, data_sharding, all_gather, gather_rows, permute

__all__ = ["sharded_logp_fn", "sharded_ensemble_step", "pt_sampler_sharded"]


def _resolve_mesh(mesh, axis):
    return make_mesh(axis_names=(axis,)) if mesh is None else mesh


def sharded_logp_fn(process, mesh=None, axis="dp"):
    """``(fn, place)``: ``place(space, inputs, outputs)`` gives this rank's
    row bands of the data; ``fn(u, space, inputs, outputs)`` is the
    process's posterior logp (``_logp_pure(prior=False)``) at the flat
    unconstrained vector ``u`` over those bands, gathering the rows the
    exact factor needs.  Differentiable in ``u``."""
    mesh = _resolve_mesh(mesh, axis)
    reg = process.active
    pure = process._logp_pure(prior=False)
    layout = data_sharding(mesh, axis=axis)

    def fn(u, space, inputs, outputs):
        params = reg.array_to_dict_tensor(as_tensor(u))
        return pure(params, *(gather_rows(mesh, t, axis) for t in (space, inputs, outputs)))

    def place(space, inputs, outputs):
        return tuple(layout.place(np.asarray(v)) for v in (space, inputs, outputs))

    return fn, place


def _split_half(gen, x_move, lp_move, x_other, logp_rows, a, mesh, axis):
    """One half-ensemble update of this rank's walkers ``x_move`` against
    the whole complementary half ``x_other``: the half's draws are taken
    whole on every rank (the generators stay in step) and sliced."""
    from ..bayesian import samplers

    d, r = mesh.axis_size(axis), mesh.axis_index(axis)
    m, ndim = x_move.shape
    u, j, log_u = samplers._half_draws(gen, (d * m,), x_other.shape[0], x_move.dtype,
                                       x_move.device)
    u, j, log_u = (t[r * m:(r + 1) * m].to(x_move.device) for t in (u, j, log_u))
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partner = x_other[j]
    y = partner + z[:, None] * (x_move - partner)
    lp_y = logp_rows(y)
    accept = log_u < (ndim - 1) * torch.log(z) + lp_y - lp_move
    return torch.where(accept[:, None], y, x_move), torch.where(accept, lp_y, lp_move)


def sharded_ensemble_step(logp, mesh=None, axis="chains"):
    """``(step, place, logp_rows)`` for the stretch move with the walker
    axis split over ``axis``.  ``place(x)`` gives this rank's walkers of
    the (chains, ndim) ensemble — its band of each half, stacked;
    ``logp_rows(x_local)`` their log density (non-finite as -inf);
    ``step(gen, x_local, lp_local) -> (x_local, lp_local)`` one iteration,
    the same as the single-device step (``samplers._ensemble_step``) with
    the same generator; ``step.gather(x_local)`` the whole ensemble in its
    order, on every rank.  ``gen`` is a ``torch.Generator`` seeded alike on
    every rank."""
    from ..bayesian.samplers import _safe

    mesh = _resolve_mesh(mesh, axis)
    d, r = mesh.axis_size(axis), mesh.axis_index(axis)

    def logp_rows(y):
        return _safe(logp(y))

    def place(x):
        x = as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        half = x.shape[0] // 2
        if x.shape[0] % 2 or half % d:
            raise ValueError(f"{x.shape[0]} walkers do not split into two halves over "
                             f"{d} ranks")
        m = half // d
        return torch.cat([x[r * m:(r + 1) * m], x[half + r * m:half + (r + 1) * m]])

    def halves(t):
        m = t.shape[0] // 2
        return t[:m], t[m:]

    def step(gen, x, lp, a=2.0):
        (x1, x2), (lp1, lp2) = halves(x), halves(lp)
        x1, lp1 = _split_half(gen, x1, lp1, all_gather(mesh, x2, axis), logp_rows, a, mesh,
                              axis)
        x2, lp2 = _split_half(gen, x2, lp2, all_gather(mesh, x1, axis), logp_rows, a, mesh,
                              axis)
        return torch.cat([x1, x2]), torch.cat([lp1, lp2])

    def gather(x):
        x1, x2 = halves(x)
        return torch.cat([all_gather(mesh, x1, axis), all_gather(mesh, x2, axis)])

    step.gather = gather
    return step, place, logp_rows


def _pair_uniform(seed, rnd, pair, shape, dtype, device):
    """The accept uniforms of the exchange between temperatures ``pair``
    and ``pair + 1`` at round ``rnd``: a generator seeded by (seed, round,
    pair), so both partners draw the same numbers (the JAX package's
    ``fold_in(key, pair)``)."""
    state = int(np.random.SeedSequence([int(seed), int(rnd), int(pair)]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(state)
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def pt_sampler_sharded(loglike, logprior, p0, samples, betas=None, mesh=None, axis="temps",
                       key=0, a=2.0):
    """Parallel tempering with one temperature a rank of ``axis``: each
    round a stretch move at the rank's beta, then a deterministic even-odd
    exchange with the neighbouring temperature (pairs (0,1)(2,3)... on even
    rounds, (1,2)(3,4)... on odd ones; Syed et al. 2019), both partners
    reading one accept uniform (:func:`_pair_uniform`).  ``loglike`` and
    ``logprior`` are batched ((R, ndim) -> (R,)); ``p0`` (ntemps, chains,
    ndim) is whole on every rank; ``key`` an int seed.  Returns temperature
    0's chain (chains, samples, ndim), a host array, on every rank."""
    from ..bayesian.samplers import _ensemble_step, _safe, default_beta_ladder

    mesh = _resolve_mesh(mesh, axis)
    ntemps, me = mesh.axis_size(axis), mesh.axis_index(axis)
    p0 = np.asarray(p0)
    if p0.shape[0] != ntemps:
        raise ValueError(f"p0 leading dim {p0.shape[0]} != mesh axis {ntemps}")
    betas = np.asarray(default_beta_ladder(ntemps) if betas is None else betas,
                       dtype=settings.floatx)
    x = as_tensor(p0[me])
    if x.shape[0] % 2:
        raise ValueError("chains must be even for the two-half stretch move")
    beta = float(betas[me])
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(
        int(np.random.SeedSequence([int(key), me]).generate_state(1)[0]))

    def like_rows(y):
        return _safe(loglike(y))

    def prior_rows(y):
        return _safe(logprior(y))

    def logp_rows(y):
        return beta * like_rows(y) + prior_rows(y), ()

    like, prior = like_rows(x), prior_rows(x)
    chain = torch.empty((samples,) + tuple(x.shape), dtype=x.dtype, device=dev)
    for rnd in range(samples):
        x, _, _ = _ensemble_step(gen, x, beta * like + prior, (), logp_rows, a)
        like, prior = like_rows(x), prior_rows(x)
        up = me % 2 == rnd % 2  # I pair with me + 1, else with me - 1
        partner = me + 1 if up else me - 1
        state = torch.cat([x, like[:, None], prior[:, None]], dim=1)
        other = permute(mesh, state, -1 if up else 1, axis)  # the partner's state
        if 0 <= partner < ntemps:
            log_u = torch.log(_pair_uniform(key, rnd, min(me, partner), like.shape, x.dtype,
                                            dev))
            log_alpha = (beta - float(betas[partner])) * (other[:, -2] - like)
            acc = log_u < log_alpha
            x = torch.where(acc[:, None], other[:, :-2], x)
            like = torch.where(acc, other[:, -2], like)
            prior = torch.where(acc, other[:, -1], prior)
        chain[rnd] = x
    chain0 = all_gather(mesh, chain[None], axis)[0]
    return chain0.transpose(0, 1).cpu().numpy()
