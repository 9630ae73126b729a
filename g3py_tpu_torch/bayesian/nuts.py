"""No-U-Turn Sampler (the PyTorch counterpart of
:mod:`g3py_tpu.bayesian.nuts`): multinomial NUTS with the iterative
tree-doubling scheme and its checkpoint stack for the U-turn checks,
dual-averaging step-size adaptation and a Welford diagonal or dense mass.

The JAX package ``vmap``-s one chain's step over the chains, so its two
``while_loop``-s (over tree depth and over the leaves of a subtree) run in
lockstep with a ``live`` mask per lane.  Here the same lockstep is written
out: a host loop over doublings and leaves, every chain's state a tensor
with a leading chain axis, per-chain step sizes and inverse masses
((C, ndim) or (C, ndim, ndim)), and every chain's leaf in ONE batched
value-and-gradient evaluation of the log density.  A chain that has
stopped is computed and masked, as under ``vmap``; the loop over leaves
ends when no chain is live, which is the one host read a leaf makes
(``reads`` counts them, ``leaves`` the leaf evaluations).

Where the JAX package evaluates the gradient at both ends of every
leapfrog step and the log density once more for the energy, each chain
here carries the log density and gradient of its tree's two edges and of
its proposal: a leaf is exactly one evaluation, and a sampler call makes
one more for its starting points.

Every random number comes from a draw function that a test can replace
(:func:`_momentum_draws`, :func:`_direction_draws`, :func:`_select_draws`,
:func:`_swap_draws`), from a ``torch.Generator`` on the chains' device
seeded from ``key``.  The JAX package's chunked path
(``chunk=``) splits its PRNG keys differently and exists for its hosted
runtime; here ``chunk`` is accepted and changes nothing.
"""

import math

import torch

from .samplers import _chain_starts, _generator, value_and_grad

__all__ = ["nuts_sampler", "nuts_warmup"]

_DIVERGENCE = 1000.0


def _momentum_draws(gen, shape, dtype, device):
    """Standard normals of the momenta, (chains, ndim)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _direction_draws(gen, shape, device):
    """The direction of each chain's doubling (True: forward), (chains,)."""
    return torch.rand(shape, generator=gen, device=device) < 0.5


def _select_draws(gen, shape, dtype, device):
    """The uniforms of each leaf's multinomial selection, (chains,)."""
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def _swap_draws(gen, shape, dtype, device):
    """The uniforms of each doubling's choice between the old tree's
    proposal and the subtree's, (chains,)."""
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def _mv(inv_mass, r):
    """M^{-1} r for a diagonal (..., ndim) or dense (..., ndim, ndim) inverse
    mass over (..., ndim) momenta."""
    if inv_mass.ndim == r.ndim + 1:
        return torch.matmul(inv_mass, r[..., None])[..., 0]
    return inv_mass * r


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _draw_momentum(gen, inv_mass, dtype):
    """r ~ N(0, M) with M = inv(inv_mass) for every chain: diagonal ->
    eps / sqrt(inv_mass); dense -> L^{-T} eps with L = chol(inv_mass)."""
    dense = inv_mass.ndim == 3
    eps = _momentum_draws(gen, inv_mass.shape[:2], dtype, inv_mass.device)
    if dense:
        chol = torch.linalg.cholesky(inv_mass)
        return torch.linalg.solve_triangular(chol.transpose(-1, -2), eps[..., None],
                                             upper=True)[..., 0]
    return eps * torch.rsqrt(inv_mass)


def _leapfrog(logp, z, r, grad, eps_signed, inv_mass):
    """One leapfrog step of every chain from ``(z, r)`` with the gradient
    ``grad`` at ``z``; ``eps_signed`` (chains,).  Returns the new ``(z, r,
    logp, grad)``: one batched evaluation."""
    step = eps_signed[:, None]
    r = r + 0.5 * step * grad
    z = z + step * _mv(inv_mass, r)
    lp, grad = value_and_grad(logp, z)
    r = r + 0.5 * step * grad
    return z, r, lp, grad


def _uturn(r_sum, r_first, r_last, inv_mass):
    """Generalized U-turn criterion on velocities v = M^{-1} r, a chain a
    row."""
    v = _mv(inv_mass, r_sum)
    return (_dot(v, r_first) <= 0.0) | (_dot(v, r_last) <= 0.0)


def _pack(z, r, grad, lp):
    """A chain's state as one row: ``[z | r | grad | logp]`` ((C, 3 ndim + 1);
    ``r`` absent for a proposal, (C, 2 ndim + 1)).  Packing makes the
    masked selections of a leaf a few ``torch.where``-s instead of one a
    field."""
    parts = (z, grad, lp[:, None]) if r is None else (z, r, grad, lp[:, None])
    return torch.cat(parts, dim=1)


def _build_subtree(logp, gen, edge, eps_signed, depth, max_depth, energy0, inv_mass, outer):
    """2^depth leapfrog steps of every chain from its packed edge state
    ``edge`` (:func:`_pack`), with iterative U-turn checks and progressive
    multinomial selection, for the chains where ``outer`` holds.  Returns
    ``None`` when no chain is live at the first leaf (the step is over for
    every chain), else ``(edge_end, r_sum, proposal, logw, accept_sum,
    turning, diverging)``, the proposal packed without momentum."""
    chains, ndim = edge.shape[0], (edge.shape[1] - 1) // 3
    # checkpoint slot k: the momentum at the first leaf of the open size-2^k
    # range, and the momentum sum before it ([r | sum])
    ckpt = edge.new_zeros((chains, max_depth + 1, 2 * ndim))
    r_sum = edge.new_zeros((chains, ndim))
    prop = torch.cat([edge[:, :ndim], edge[:, 2 * ndim:]], dim=1)
    logw = torch.full((chains,), -math.inf, dtype=edge.dtype, device=edge.device)
    acc_sum = torch.zeros_like(logw)
    flags = torch.zeros((chains, 2), dtype=torch.bool, device=edge.device)  # turning, diverging
    for n in range(2 ** depth):
        live = outer & ~flags.any(dim=1)
        nuts_sampler.reads += 1
        if not bool(live.any()):
            if n == 0:
                return None
            break
        nuts_sampler.leaves += 1
        lv = live[:, None]
        z_new, r_new, lp_new, g_new = _leapfrog(logp, edge[:, :ndim], edge[:, ndim:2 * ndim],
                                                edge[:, 2 * ndim:3 * ndim], eps_signed,
                                                inv_mass)
        energy = -lp_new + 0.5 * _dot(_mv(inv_mass, r_new), r_new)
        delta = energy - energy0
        div = ~torch.isfinite(delta) | (delta > _DIVERGENCE)
        logw_leaf = torch.where(div, torch.full_like(delta, -math.inf), -delta)
        accept_leaf = torch.where(div, torch.zeros_like(delta),
                                  torch.clamp(torch.exp(-delta), max=1.0))
        r_sum_new = r_sum + r_new

        # close ranges ending at this leaf: slot k when (n+1) % 2^k == 0
        # (never a slot that this leaf opens, so the checkpoint is the old one)
        turning = flags[:, 0].clone()
        for k in range(1, max_depth + 1):
            if (n + 1) % 2 ** k == 0:
                turning |= _uturn(r_sum_new - ckpt[:, k, ndim:], ckpt[:, k, :ndim], r_new,
                                  inv_mass)
        # open ranges starting at this leaf: slot k when n % 2^k == 0
        store = [k for k in range(max_depth + 1) if n % 2 ** k == 0]
        ckpt[:, store] = torch.where(lv[:, None], torch.cat([r_new, r_sum], 1)[:, None],
                                     ckpt[:, store])

        # progressive multinomial proposal within the subtree
        logw_new = torch.logaddexp(logw, logw_leaf)
        u = _select_draws(gen, (chains,), edge.dtype, edge.device)
        take = (torch.log(u) < (logw_leaf - logw_new)) & live
        prop = torch.where(take[:, None], _pack(z_new, None, g_new, lp_new), prop)

        edge = torch.where(lv, _pack(z_new, r_new, g_new, lp_new), edge)
        r_sum = torch.where(lv, r_sum_new, r_sum)
        logw = torch.where(live, logw_new, logw)
        acc_sum = torch.where(live, acc_sum + accept_leaf, acc_sum)
        flags = torch.where(lv, torch.stack([turning, flags[:, 1] | div], 1), flags)
    return edge, r_sum, prop, logw, acc_sum, flags[:, 0], flags[:, 1]


def _nuts_step(logp, gen, z, lp, grad, eps, max_depth, inv_mass):
    """One NUTS transition of every chain from ``z`` (chains, ndim) with its
    log density ``lp`` and gradient ``grad``; ``eps`` (chains,),
    ``inv_mass`` (chains, ndim) or (chains, ndim, ndim).  Returns ``(z, lp,
    grad)`` of the proposal and each chain's mean acceptance statistic,
    tree depth and divergence flag."""
    chains, ndim = z.shape
    r0 = _draw_momentum(gen, inv_mass, z.dtype)
    energy0 = -lp + 0.5 * _dot(_mv(inv_mass, r0), r0)
    left = right = _pack(z, r0, grad, lp)
    r_sum = r0
    prop = _pack(z, None, grad, lp)
    logw = torch.zeros_like(lp)
    acc_sum, acc_count = torch.zeros_like(lp), torch.zeros_like(lp)
    depth = torch.zeros(chains, dtype=torch.int64, device=z.device)
    turning = torch.zeros(chains, dtype=torch.bool, device=z.device)
    diverging = torch.zeros_like(turning)
    for j in range(max_depth):
        outer = ~turning & ~diverging
        go_right = _direction_draws(gen, (chains,), z.device)
        direction = torch.where(go_right, 1.0, -1.0).to(z.dtype)
        gr = go_right[:, None]
        edge = torch.where(gr, right, left)
        sub = _build_subtree(logp, gen, edge, eps * direction, j, max_depth, energy0, inv_mass,
                             outer)
        if sub is None:
            break
        end, sub_sum, sub_prop, sub_logw, sub_acc, sub_turn, sub_div = sub
        ov = outer[:, None]
        left = torch.where(ov & ~gr, end, left)
        right = torch.where(ov & gr, end, right)

        # biased progressive sampling between the old tree and the subtree
        ok = ~sub_turn & ~sub_div
        u = _swap_draws(gen, (chains,), z.dtype, z.device)
        swap = torch.log(u) < (sub_logw - logw)
        prop = torch.where((outer & ok & swap)[:, None], sub_prop, prop)
        logw = torch.where(outer & ok, torch.logaddexp(logw, sub_logw), logw)
        r_sum = torch.where(ov & ok[:, None], r_sum + sub_sum, r_sum)
        turning_total = _uturn(r_sum, left[:, ndim:2 * ndim], right[:, ndim:2 * ndim], inv_mass)
        acc_sum = torch.where(outer, acc_sum + sub_acc, acc_sum)
        acc_count = torch.where(outer, acc_count + 2.0 ** j, acc_count)
        depth = torch.where(outer, depth + 1, depth)
        turning = torch.where(outer, sub_turn | turning_total, turning)
        diverging = torch.where(outer, diverging | sub_div, diverging)
    accept = torch.where(acc_count > 0, acc_sum / torch.clamp(acc_count, min=1.0),
                         torch.zeros_like(acc_sum))
    return (prop[:, :ndim], prop[:, 2 * ndim], prop[:, ndim:2 * ndim]), accept, depth, diverging


def _mass_from_var(var, n1, dense, dtype):
    """Regularized (co)variance -> inverse mass (Stan's diag_e/dense_e), a
    chain a row: (chains, ndim) or (chains, ndim, ndim)."""
    reg = n1 / (n1 + 5.0)
    if dense:
        ndim = var.shape[-1]
        eye = torch.eye(ndim, dtype=dtype, device=var.device)
        inv_mass = reg * var + (1.0 - reg) * 1e-3 * eye
        # guard: a non-PSD estimate (short phase 1) falls back to its diagonal
        chol, info = torch.linalg.cholesky_ex(inv_mass)
        bad = (info != 0) | ~torch.isfinite(chol).flatten(-2).all(dim=-1)
        diag = torch.diag_embed(torch.clamp(torch.diagonal(var, dim1=-2, dim2=-1), min=1e-10)
                                * reg + (1.0 - reg) * 1e-3)
        return torch.where(bad[:, None, None], diag, inv_mass)
    return reg * torch.clamp(var, min=1e-10) + (1.0 - reg) * 1e-3


class _DualAveraging:
    """Dual-averaging step-size adaptation (Hoffman & Gelman 2014,
    Algorithm 5) of every chain, with a Welford accumulator of the
    posterior (co)variance."""

    gamma, t0, kappa = 0.05, 10.0, 0.75

    def __init__(self, z, eps0, mu, target, dense):
        chains, ndim = z.shape
        self.log_eps = torch.log(eps0)
        self.log_eps_bar = torch.zeros_like(eps0)
        self.h_bar = torch.zeros_like(eps0)
        self.mu, self.target, self.dense = mu, target, dense
        self.w_mean = torch.zeros_like(z)
        self.w_m2 = z.new_zeros((chains, ndim, ndim) if dense else (chains, ndim))

    def update(self, m, accept, z_new):
        """Iteration ``m`` (0-based) with each chain's acceptance statistic
        and new state."""
        mm = m + 1.0
        eta = 1.0 / (mm + self.t0)
        self.h_bar = (1.0 - eta) * self.h_bar + eta * (self.target - accept)
        self.log_eps = self.mu - math.sqrt(mm) / self.gamma * self.h_bar
        w = mm ** (-self.kappa)
        self.log_eps_bar = w * self.log_eps + (1.0 - w) * self.log_eps_bar
        delta = z_new - self.w_mean
        self.w_mean = self.w_mean + delta / mm
        delta2 = z_new - self.w_mean
        self.w_m2 = self.w_m2 + (delta[:, :, None] * delta2[:, None, :] if self.dense
                                 else delta * delta2)


def _dual_avg_phase(logp, gen, state, iters, max_depth, inv_mass, target, eps0, dense):
    """One dual-averaging phase of every chain from ``state = (z, lp,
    grad)``; returns the final state, each chain's adapted step size
    exp(log_eps_bar) and the Welford (co)variance."""
    mu = torch.log(10.0 * eps0)
    da = _DualAveraging(state[0], eps0, mu, target, dense)
    for m in range(iters):
        state, accept, _, _ = _nuts_step(logp, gen, *state, torch.exp(da.log_eps), max_depth,
                                         inv_mass)
        da.update(float(m), accept, state[0])
    return state, torch.exp(da.log_eps_bar), da.w_m2 / max(iters - 1, 1)


def _warmup(logp, gen, state, warmup, max_depth, target, adapt_mass):
    """Two-phase warmup of every chain (the JAX package's
    ``_nuts_warmup_impl``): dual averaging with unit mass while estimating
    the posterior (co)variance, then again under the fitted mass, restarted
    at mu = log(10 eps_1).  Returns the state, the step sizes (chains,) and
    the inverse masses."""
    z = state[0]
    ones = torch.ones_like(z)
    dense = adapt_mass == "dense"
    n1 = warmup // 2 if adapt_mass else warmup
    eps0 = torch.full_like(state[1], 0.1)
    state, eps, var = _dual_avg_phase(logp, gen, state, n1, max_depth, ones, target, eps0,
                                      dense)
    if not adapt_mass:
        return state, eps, ones
    inv_mass = _mass_from_var(var, n1, dense, z.dtype)
    state, eps, _ = _dual_avg_phase(logp, gen, state, warmup - n1, max_depth, inv_mass, target,
                                    eps, False)
    return state, eps, inv_mass


def nuts_warmup(logp, z0, warmup=200, key=None, max_depth=8, adapt_mass=True,
                target_accept=0.8):
    """Adapt the step size and the (diagonal, or with ``adapt_mass='dense'``
    dense) mass from ``z0`` (ndim,); returns ``(z_adapted, eps,
    inv_mass)`` on the host.  ``logp`` is a batched log density that torch
    can differentiate ((R, ndim) -> (R,)); ``key`` an int seed or a
    ``torch.Generator`` on ``settings.device``."""
    z = _chain_starts(z0, 1)
    gen = _generator(key, z.device)
    state = (z,) + value_and_grad(logp, z)
    state, eps, inv_mass = _warmup(logp, gen, state, warmup, max_depth, target_accept,
                                   adapt_mass)
    return state[0][0].cpu().numpy(), float(eps[0]), inv_mass[0].cpu().numpy()


def nuts_sampler(logp, z0, samples, eps=None, warmup=200, key=None, max_depth=8, chains=1,
                 adapt_mass=True, target_accept=0.8, chunk=None):
    """Run NUTS; returns ``(chain (chains, samples, ndim), lnprob (chains,
    samples), info)`` on the host, ``info`` with each chain's
    ``accept_rate``, ``mean_tree_depth``, ``divergences`` and
    ``step_size`` (the JAX package's keys).

    ``logp`` is a batched log density of the flat unconstrained vector,
    (R, ndim) tensor -> (R,) tensor, that torch can differentiate (the
    models' ``_sampling_logps`` make one batched value-and-gradient
    evaluation of all chains a leaf).  ``z0`` is (ndim,) (every chain
    starts there) or (chains, ndim).  With ``eps`` None each chain adapts
    its own step size and mass over ``warmup`` iterations
    (``adapt_mass``: True a diagonal, ``'dense'`` the full covariance,
    False unit mass) toward ``target_accept``; a given ``eps`` runs every
    chain at it with unit mass.  ``key`` is an int seed or a
    ``torch.Generator`` on ``settings.device``.  ``chunk`` is accepted for
    the JAX package's signature and changes nothing (its chunked dispatch
    exists for that package's hosted runtime).

    A call makes one batched evaluation for the starting points and one a
    leaf; ``nuts_sampler.leaves`` and ``nuts_sampler.reads`` count the leaf
    evaluations and the host reads of the live flag."""
    z = _chain_starts(z0, chains)
    n_chains = z.shape[0]
    gen = _generator(key, z.device)
    state = (z,) + value_and_grad(logp, z)
    if eps is None:
        state, eps_vec, inv_mass = _warmup(logp, gen, state, warmup, max_depth, target_accept,
                                           adapt_mass)
    else:
        eps_vec = torch.full((n_chains,), float(eps), dtype=z.dtype, device=z.device)
        inv_mass = torch.ones_like(z)
    chain = z.new_empty((samples,) + z.shape)
    lnprob = z.new_empty((samples, n_chains))
    accepts = z.new_empty((samples, n_chains))
    depths = torch.empty((samples, n_chains), dtype=torch.int64, device=z.device)
    divs = torch.empty((samples, n_chains), dtype=torch.bool, device=z.device)
    for it in range(samples):
        state, accepts[it], depths[it], divs[it] = _nuts_step(logp, gen, *state, eps_vec,
                                                             max_depth, inv_mass)
        chain[it], lnprob[it] = state[0], state[1]
    info = {"accept_rate": accepts.mean(dim=0).cpu().numpy(),
            "mean_tree_depth": depths.to(torch.float32).mean(dim=0).cpu().numpy(),
            "divergences": divs.sum(dim=0).cpu().numpy(),
            "step_size": eps_vec.cpu().numpy()}
    return chain.transpose(0, 1).cpu().numpy(), lnprob.T.cpu().numpy(), info


nuts_sampler.leaves = 0
nuts_sampler.reads = 0
