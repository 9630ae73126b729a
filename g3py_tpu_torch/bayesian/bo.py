"""Bayesian optimization over any process with posterior statistics (the
PyTorch counterpart of :mod:`g3py_tpu.bayesian.bo`).

The acquisitions are built from the process's posterior mean and standard
deviation at a candidate batch, and the multi-start ascent differentiates
them with torch autograd through the posterior algebra: every start ascends
in one (starts, d) tensor, with Adam in unit-box coordinates.

The observed gram is factored ONCE per conditioning set (the process's
``posterior_state``: K1 and K2 on the card), and an acquisition evaluation
is one cross gram (K1, with its gradient into the candidates) and products
with the state.  The JAX package refactors inside every call; with the
state as a constant of the ascent the value and its gradient in the
candidates are the same function.  A process without a factored state (the
state-space and sparse families) goes through its ``th_mean``/``th_std``.

Acquisitions: ``logEI`` (default; Ament et al., NeurIPS 2023: the log of
expected improvement, stable where EI underflows), ``EI``, ``PI`` (the log
probability of improvement), ``UCB`` (mu + beta sigma) and ``thompson``
(pathwise Matheron draws argmaxed over a candidate set).  ``q > 1`` with an
analytic acquisition proposes sequentially through fantasies (Ginsbourger et
al. 2010): the conditioning set grows by the pick and a lie (``liar='mean'``
the kriging believer, ``'best'``/``'worst'`` the constant liars), and the
hyperparameters stay fixed.  The candidates come from the same
``np.random.default_rng(seed)`` stream as in the JAX package.
"""

import math

import numpy as np
import torch

from ..config import settings
from ..ops.special import ndtr

__all__ = ["BayesOpt"]

_LOG_SQRT2PI = 0.5 * math.log(2.0 * math.pi)
# Adam as optax.adam(0.05) runs it (b1, b2, eps, eps_root = 0)
_ADAM = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8)


def _norm_logpdf(z):
    return -0.5 * z * z - _LOG_SQRT2PI


def _floor(x, lo):
    """max(x, lo) as ``jnp.clip`` takes it: half the gradient at a tie."""
    return torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))


def _unit_clip(u):
    """u clipped to [0, 1] as ``jnp.clip`` takes it (max, then min)."""
    return torch.minimum(_floor(u, 0.0), torch.ones((), dtype=u.dtype, device=u.device))


def _log_h(z):
    """log(phi(z) + z Phi(z)), the log-EI kernel, stable over all z: the
    direct form above z = -4, the asymptotic phi(z)/z^2 (1 - 3/z^2) in the
    far-left tail."""
    direct = torch.log(_floor(torch.exp(_norm_logpdf(z)) + z * ndtr(z), 1e-30))
    zs = torch.minimum(z, -torch.ones((), dtype=z.dtype, device=z.device))
    tail = (_norm_logpdf(zs) - 2.0 * torch.log(-zs)
            + torch.log1p(_floor(-3.0 / (zs * zs), -0.999)))
    return torch.where(z > -4.0, direct, tail)


class BayesOpt:
    """Sequential model-based optimization of a black-box objective over a
    box domain, driven by any process with posterior statistics.

    ``process`` is the surrogate (its data grow as observations arrive);
    ``bounds`` the (d, 2) [low, high] rows; ``maximize`` the direction of
    the objective (the surrogate models raw y, the acquisition flips
    signs); ``xi`` the exploration offset of EI/logEI/PI; ``beta`` UCB's
    multiplier; ``noise_floor`` the refit's floor on the noise variances,
    relative to the observed variance; ``seed`` seeds the candidates."""

    def __init__(self, process, bounds, maximize=True, xi=0.0, beta=2.0, noise_floor=1e-5,
                 seed=0):
        self.process = process
        self.bounds = np.asarray(bounds, dtype=settings.floatx)
        if self.bounds.ndim != 2 or self.bounds.shape[1] != 2:
            raise ValueError("bounds must be (d, 2) [low, high] rows")
        if np.any(self.bounds[:, 1] <= self.bounds[:, 0]):
            raise ValueError("every bounds row needs high > low")
        self.d = self.bounds.shape[0]
        self.maximize = bool(maximize)
        self.xi = float(xi)
        self.beta = float(beta)
        self.noise_floor = float(noise_floor)
        self.rng = np.random.default_rng(seed)
        self.history = {"x": [], "y": [], "best_y": []}
        self.last_starts = None

    # -- data ------------------------------------------------------------
    @property
    def _sign(self):
        return 1.0 if self.maximize else -1.0

    def tell(self, x, y):
        """Record evaluations (x (q, d) or (d,), y (q,) or a scalar) and push
        them into the surrogate's observed data."""
        x = np.atleast_2d(np.asarray(x, dtype=settings.floatx))
        y = np.atleast_1d(np.asarray(y, dtype=settings.floatx))
        proc = self.process
        # as the JAX package: the data the process holds come first, the
        # constructor's two placeholder rows of a process never observed too
        xs = x if proc.inputs is None or not np.ndim(proc.inputs) else np.concatenate(
            [np.asarray(proc.inputs), x])
        ys = y if proc.outputs is None else np.concatenate([np.asarray(proc.outputs), y])
        proc.observed(xs, ys)
        for xi_, yi_ in zip(x, y):
            self.history["x"].append(np.asarray(xi_))
            self.history["y"].append(float(yi_))
            self.history["best_y"].append((max if self.maximize else min)(self.history["y"]))

    def best(self):
        """(x_best, y_best) among the evaluated points."""
        ys = np.asarray(self.history["y"])
        i = int(np.argmax(ys) if self.maximize else np.argmin(ys))
        return self.history["x"][i], float(ys[i])

    # -- acquisition -----------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=settings.floatx), device=settings.device)

    def _conditioned(self, params, inputs, outputs):
        """The params dict of tensors, with the posterior state of this
        conditioning set merged in where the process has one (factored once:
        one K1 gram and one K2 factorization)."""
        proc = self.process
        p = proc._tensor_params(proc.filter_params(params))
        if hasattr(proc, "_posterior_state_pure"):
            p = {**p, **proc._posterior_state_pure(p, inputs, outputs)}
        return p

    def _moments(self, p, X, inputs, outputs):
        """Posterior (mean, std) of the observed process at X: from one
        cross gram where the process has the fused latent moments, else
        from its ``th_mean``/``th_std``."""
        proc = self.process
        if hasattr(proc, "_latent_moments"):
            loc, latent, _ = proc._latent_moments(p, X, inputs, outputs)
            mean, var = proc._moments_fn(p, inputs, outputs)(loc, latent)
            return mean, torch.sqrt(var)
        vec = torch.zeros(0, dtype=settings.dtype, device=settings.device)
        return (proc.th_mean(noise=False)(p, X, inputs, outputs, vec),
                proc.th_std(noise=False)(p, X, inputs, outputs, vec))

    def _acq(self, kind, p, X, inputs, outputs, best_g):
        """(m,) acquisition values at X (maximization direction).  A
        degenerate surrogate gives a bad value, never a NaN that would
        poison the whole ascent."""
        mean, std = self._moments(p, X, inputs, outputs)
        mu = torch.nan_to_num(self._sign * mean, nan=-1e30, posinf=1e30, neginf=-1e30)
        sd = _floor(torch.nan_to_num(std, nan=1e-10, posinf=1e30), 1e-10)
        z = (mu - best_g - self.xi) / sd
        if kind == "EI":
            return sd * (torch.exp(_norm_logpdf(z)) + z * ndtr(z))
        if kind == "logEI":
            return torch.log(sd) + _log_h(z)
        if kind == "PI":
            return torch.special.log_ndtr(z)
        if kind == "UCB":
            return mu + self.beta * sd
        raise ValueError(f"unknown acquisition {kind!r}")

    def acquisition(self, X, params=None, kind="logEI"):
        """The acquisition at a candidate batch X (host array)."""
        inputs, outputs, best_g = self._data()
        p = self._conditioned(self._params(params), inputs, outputs)
        with torch.no_grad():
            return self._acq(kind, p, self._tensor(np.atleast_2d(X)), inputs, outputs,
                             best_g).cpu().numpy()

    def _params(self, params):
        return self.process.params if params is None else params

    def _data(self):
        """The observed inputs and outputs as device tensors, and the
        incumbent best in the objective direction."""
        inputs = self._tensor(self.process.inputs)
        outputs = self._tensor(self.process.outputs)
        ys = np.asarray(self.history["y"] if self.history["y"] else self.process.outputs,
                        dtype=settings.floatx)
        return inputs, outputs, self._tensor(np.max(self._sign * ys))

    def _uniform(self, m):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (lo + (hi - lo) * self.rng.random((m, self.d))).astype(settings.floatx)

    # -- suggestion --------------------------------------------------------
    def suggest(self, params=None, kind="logEI", q=1, candidates=2048, starts=16, steps=60,
                key=None, liar="mean"):
        """Propose the next evaluation point(s).

        ``kind='thompson'`` draws ``q`` consistent posterior paths on the
        candidate set and argmaxes each.  The analytic acquisitions screen
        ``candidates`` uniform points, ascend the best ``starts`` with Adam
        (all starts in one tensor) and return the argmax.  ``q > 1`` with an
        analytic acquisition proposes through fantasies: ``liar='mean'``
        conditions each next ascent on the posterior mean at the previous
        pick, ``'best'``/``'worst'`` on the incumbent best/worst value.
        Returns a (d,) point when ``q == 1``, else a (q, d) batch."""
        params = self._params(params)
        if kind == "thompson":
            return self._suggest_thompson(params, q, candidates, key)
        inputs, outputs, best_g = self._data()
        if q == 1:
            p = self._conditioned(params, inputs, outputs)
            return self._suggest_one(p, kind, inputs, outputs, best_g, candidates, starts,
                                     steps)
        if liar not in ("mean", "best", "worst"):
            raise ValueError("liar must be 'mean', 'best' or 'worst'")
        picks = []
        for _ in range(int(q)):
            p = self._conditioned(params, inputs, outputs)
            x = self._suggest_one(p, kind, inputs, outputs, best_g, candidates, starts, steps)
            picks.append(x)
            y_f = self._fantasy(p, x, inputs, outputs, liar)
            inputs = torch.cat([inputs, self._tensor(x)[None]])
            outputs = torch.cat([outputs, y_f.reshape(1)])
            best_g = torch.maximum(best_g, self._sign * y_f)
        return np.stack(picks)

    def _fantasy(self, p, x, inputs, outputs, liar):
        """The imagined observation (raw-y space) at a pick, given the
        current (fantasized) conditioning set ``p`` was factored on."""
        if liar == "mean":
            with torch.no_grad():
                mu = self._moments(p, self._tensor(x)[None], inputs, outputs)[0][0]
            # a non-finite believer mean must not become the incumbent:
            # the lie is clamped to the observed range
            lo, hi = outputs.min(), outputs.max()
            mu = torch.where(torch.isnan(mu), 0.5 * (lo + hi), mu)
            return torch.minimum(torch.maximum(mu, lo), hi)
        g = self._sign * outputs
        return self._sign * (g.max() if liar == "best" else g.min())

    def _suggest_one(self, p, kind, inputs, outputs, best_g, candidates, starts, steps):
        """Screen, then the multi-start Adam ascent of one analytic
        acquisition against one conditioning set (factored in ``p``)."""
        cand = self._tensor(self._uniform(candidates))
        with torch.no_grad():
            vals = self._acq(kind, p, cand, inputs, outputs, best_g)
        top = torch.argsort(vals, stable=True)[-starts:]
        lo, hi = self._tensor(self.bounds[:, 0]), self._tensor(self.bounds[:, 1])
        u = (cand[top] - lo) / (hi - lo)
        m, v = torch.zeros_like(u), torch.zeros_like(u)
        b1, b2 = _ADAM["b1"], _ADAM["b2"]
        for t in range(1, steps + 1):
            with torch.enable_grad():
                ug = u.detach().requires_grad_(True)
                total = -self._acq(kind, p, lo + _unit_clip(ug) * (hi - lo), inputs, outputs,
                                   best_g).sum()
                (g,) = torch.autograd.grad(total, ug)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + _ADAM["eps"])
            u = _unit_clip(u - _ADAM["lr"] * step)
        xf = lo + _unit_clip(u) * (hi - lo)
        self.last_starts = xf  # the ascent's final points, for inspection
        with torch.no_grad():
            vf = self._acq(kind, p, xf, inputs, outputs, best_g)
        # a start whose ascent diverged must not win
        ok = torch.isfinite(xf).all(dim=1) & torch.isfinite(vf)
        vf = torch.where(ok, vf, torch.full_like(vf, -math.inf))
        pick = xf[torch.argmax(vf)].cpu().numpy()
        if not np.all(np.isfinite(pick)):
            finite_vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, -math.inf))
            pick = cand[int(torch.argmax(finite_vals))].cpu().numpy()
        return pick

    def _suggest_thompson(self, params, q, candidates, key):
        """``q`` posterior paths drawn on ``candidates`` uniform points
        (``Predictor.pathwise_sampler``), each argmaxed: ``key`` is the
        sampler's key (a seed, a ``torch.Generator`` or a dict of draws),
        one drawn from the candidates' stream when None."""
        pr = self.process.predictor(params)
        cand = self._uniform(candidates)
        draws = pr.pathwise_sampler(space=cand, samples=int(q),
                                    key=int(self.rng.integers(2**31)) if key is None else key)
        picks = np.argmax(self._sign * draws.cpu().numpy(), axis=0)
        out = cand[picks]
        return out[0] if q == 1 else out

    def _refit(self, params, find_map_kwargs):
        """``find_MAP`` warm-started, then the observation-noise variances
        floored at ``noise_floor`` times the observed variance: BFGS on an
        interpolating design drives the noise to an exact 0, after which
        near-duplicate evaluations make the gram singular."""
        params = self.process.find_MAP(start=params, **find_map_kwargs)
        if self.noise_floor > 0 and self.history["y"]:
            yv = float(np.var(np.asarray(self.history["y"]))) or 1.0
            floor = np.asarray(self.noise_floor * yv, settings.floatx)
            for k, v in list(params.items()):
                if "Noise_var" in k or "Lik_var" in k:
                    params[k] = np.maximum(np.asarray(v, settings.floatx), floor)
        return params

    # -- the loop ----------------------------------------------------------
    def run(self, f, iters=20, init=None, params=None, kind="logEI", q=1, refit_every=1,
            find_map_kwargs=None, display=False, **kw):
        """A uniform initial design, then iterations of suggest, evaluate,
        tell and refit.  Returns (params, history).  ``f`` maps a (d,) point
        to a scalar objective value."""
        find_map_kwargs = dict(points=1, powell=False, display=False, **(find_map_kwargs or {}))
        if init is None:
            init = max(4, 2 * self.d)
        if not self.history["y"]:
            x0 = self._uniform(init)
            self.tell(x0, np.asarray([np.asarray(f(x)).item() for x in x0],
                                     dtype=settings.floatx))
        params = self._refit(params, find_map_kwargs)
        for it in range(iters):
            xq2 = np.atleast_2d(self.suggest(params=params, kind=kind, q=q, **kw))
            yq = np.asarray([np.asarray(f(x)).item() for x in xq2], dtype=settings.floatx)
            self.tell(xq2, yq)
            if (it + 1) % refit_every == 0:
                params = self._refit(params, find_map_kwargs)
            if display:
                print(f"BO iter {it + 1}: tried {np.round(xq2, 3)} -> {yq}; "
                      f"best {self.history['best_y'][-1]:.4f}")
        return params, self.history
