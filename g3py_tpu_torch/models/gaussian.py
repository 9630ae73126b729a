"""GaussianProcess / WarpedGaussianProcess (the PyTorch counterpart of
:mod:`g3py_tpu.models.gaussian`, subset).

The GP observed density is the warped multivariate normal

  logp = -n/2 log 2pi - 1/2 |L^{-1}(T^{-1}y - mu)|^2 - sum log diag L
         + log|det dT^{-1}(y)|

with four guards falling to -1e30; quantiles are analytic
(``T(mu + z_q sigma)``); samples push Cholesky-coloured normals through
the warping; WGP moments are Gauss-Hermite quadratures of T and T^2 over
the latent gaussian.  ``loo`` is the leave-one-out log pseudo-likelihood
(GPML §5.4.2), also a ``find_MAP`` objective.
"""

import math
from statistics import NormalDist

import numpy as np
import torch

from ..config import settings, as_tensor, host_statistic, device_statistics
from ..ops.guards import to_num, to_cov
from ..ops.linalg import mvn_quad_logdet, mvn_loo, solve_lower_triangular, cho_solve
from ..ops.quadrature import gauss_hermite, hermite_moments
from .elliptical import EllipticalProcess, _contains_kernel_noise

__all__ = ["GaussianProcess", "WarpedGaussianProcess", "warped_gaussian_logp_cho",
           "WarpedGaussianDistribution"]

LOG2PI = math.log(2.0 * math.pi)


def _guarded(r, bad):
    guard = settings.logp_guard
    return torch.where(bad, torch.full_like(r, guard), to_num(r, nan=guard, neginf=guard))


def warped_gaussian_logp_cho(value, mu, cho, mapping_inv_value, logdet_dinv):
    """logp of a warped gaussian given a Cholesky factor ``cho`` (full or
    diagonal) of its dispersion; ``mapping_inv_value`` and ``logdet_dinv``
    are the warping's pullback of ``value`` and its log-Jacobian.  A
    non-finite residual, Jacobian, factor or whitened residual, or a
    NaN/-inf result, gives ``settings.logp_guard``.  Stacks of R densities
    ((R, m) residuals, (R, m, m) factors) give (R,)."""
    delta = mapping_inv_value - mu
    lcho = solve_lower_triangular(cho, delta)
    r = (-0.5 * cho.shape[-1] * LOG2PI - 0.5 * (lcho * lcho).sum(dim=-1)
         - torch.log(torch.diagonal(cho, dim1=-2, dim2=-1)).sum(dim=-1) + logdet_dinv)
    return _guarded(r, _any_nonfinite(delta, logdet_dinv, cho, lcho))


def _any_nonfinite(delta, logdet, cho, lcho):
    """Whether any of a logp's pieces is non-finite, one flag a density
    (the rows of a stack of densities lead each piece, and broadcast)."""
    def flag(t, event):
        bad = ~torch.isfinite(t)
        return bad.flatten(start_dim=bad.ndim - event).any(dim=-1) if event else bad

    return flag(delta, 1) | flag(logdet, 0) | flag(cho, 2) | flag(lcho, 1)


def _masked_parts(mapping, location, kernel_noise, params, inputs, outputs, w):
    """The masked gram ``w w' o K + diag(1 - w)``, the masked residual, the
    masked log-Jacobian and the count of included points, for the masked
    loglikes of the GP and Student-t families (a leading row axis on the
    params or on ``w`` gives a stack)."""
    w = torch.as_tensor(w, dtype=settings.dtype, device=inputs.device)
    mu = location(params, inputs)
    cov = to_cov(kernel_noise.cov(params, inputs))
    covw = cov * (w[..., :, None] * w[..., None, :]) + torch.diag_embed(1.0 - w)
    resid = (to_num(mapping.inv(params, outputs)) - mu) * w
    logdet_map = (mapping.logdet_dinv_elem(params, outputs) * w).sum(dim=-1)
    return covw, resid, logdet_map, w.sum(dim=-1)


class WarpedGaussianDistribution:
    """Namespace kept for the reference's API."""

    logp_cho = staticmethod(warped_gaussian_logp_cho)


class GaussianProcess(EllipticalProcess):
    """Exact (optionally warped-observation) Gaussian process regression."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "GP")
        super().__init__(*args, **kwargs)

    def th_define_process(self):
        self.distribution = WarpedGaussianDistribution

    def th_loglike_fn(self):
        """Observed-data loglikelihood: the warped MVN over the prior moments
        of the inputs, through ``mvn_quad_logdet``.  A failed factorization,
        a non-finite quadratic form or Jacobian, or a NaN/-inf result gives
        ``settings.logp_guard``."""
        mapping = self.f_mapping
        location = self.f_location
        kernel_noise = self.f_kernel_noise

        def fn(params, space, inputs, outputs):
            mu = location(params, inputs)
            cov = to_cov(kernel_noise.cov(params, inputs))
            tinv = to_num(mapping.inv(params, outputs))
            logdet_map = mapping.logdet_dinv(params, outputs)
            quad, logdet_half, ok = mvn_quad_logdet(cov, tinv - mu)
            n = inputs.shape[0]
            r = -0.5 * n * LOG2PI - 0.5 * quad - logdet_half + logdet_map
            return _guarded(r, (ok == 0) | ~torch.isfinite(quad) | ~torch.isfinite(logdet_map))

        return fn

    def th_loglike_masked_fn(self):
        """Masked-observation loglikelihood ``fn(params, inputs, outputs, w)``
        with ``w`` a {0,1} inclusion vector (or (R, n) rows of them beside a
        params dict of R rows) — exactly the loglike of the included
        submatrix, at one shape for every split.  The excluded coordinates
        leave the gram as identity rows, ``K_w = w w' o K + diag(1 - w)``,
        and their residuals are zeroed: the factorization is block-diagonal
        and the excluded block adds 0 to the quadratic form and the
        log-determinant.  R rows are one batched K1 and one batched K2
        call."""
        mapping = self.f_mapping
        location = self.f_location
        kernel_noise = self.f_kernel_noise

        def fn(params, inputs, outputs, w):
            covw, resid, logdet_map, n_eff = _masked_parts(mapping, location, kernel_noise,
                                                           params, inputs, outputs, w)
            quad, logdet_half, ok = mvn_quad_logdet(covw, resid)
            r = -0.5 * n_eff * LOG2PI - 0.5 * quad - logdet_half + logdet_map
            return _guarded(r, (ok == 0) | ~torch.isfinite(quad) | ~torch.isfinite(logdet_map))

        return fn

    def fit_splits(self, masks, start=None, points=4, max_iters=200, tol=1e-5,
                   noise_mult=0.2, seed=0, shard=False, mesh=None, pair_chunk=None):
        """Train this model on every observation split at once: one batched
        L-BFGS over the (split, start) pairs on the masked loglike
        (:meth:`th_loglike_masked_fn`, :mod:`g3py_tpu_torch.bayesian.fanout`).
        Returns (the per-split best params list, the (S, points) logp
        matrix)."""
        from ..bayesian.fanout import fit_splits as _fit_splits
        return _fit_splits(self, masks, start=start, points=points, max_iters=max_iters,
                           tol=tol, noise_mult=noise_mult, seed=seed, shard=shard, mesh=mesh,
                           pair_chunk=pair_chunk)

    def th_loo_fn(self):
        """Leave-one-out log pseudo-likelihood ``fn(params, space, inputs,
        outputs)`` (GPML eq. 5.10-5.12): one factorization serves every
        fold, with ``Kinv = L^{-T} L^{-1}`` and ``r = T^{-1}y - m``,

          LOO = sum_i log N(r_i | r_i - [Kinv r]_i / Kinv_ii, 1 / Kinv_ii)
                + log|det dT^{-1}(y)|

        — the Jacobian term makes it a log-density of the observed y, so a
        WGP's LOO compares with a GP's on the same data.  Differentiable
        through ``mvn_loo``'s analytic backward; a non-finite ``Kinv r`` or
        Jacobian gives ``settings.logp_guard``."""
        mapping = self.f_mapping
        location = self.f_location
        kernel_noise = self.f_kernel_noise

        def fn(params, space, inputs, outputs):
            mu = location(params, inputs)
            cov = to_cov(kernel_noise.cov(params, inputs))
            resid = to_num(mapping.inv(params, outputs)) - mu
            total, finite = mvn_loo(cov, resid)
            logdet_map = mapping.logdet_dinv(params, outputs)
            out = -0.5 * inputs.shape[0] * LOG2PI + total + logdet_map
            return _guarded(out, ~finite | ~torch.isfinite(logdet_map))

        return fn

    def loo(self, params=None, space=None, inputs=None, outputs=None, **kwargs):
        """Leave-one-out log pseudo-likelihood of the observed data (the sum
        over folds of the held-out log predictive density, see
        :meth:`th_loo_fn`).  Higher is better."""
        p = self._tensor_params(self.params if params is None else params)
        space, inputs, outputs = self._resolve_data(space, inputs, outputs)
        with torch.no_grad():
            return float(self.th_loo_fn()(p, space, inputs, outputs))

    def th_logpredictive(self, prior=False, noise=False):
        """Independent-marginal log predictive density of ``vector`` at the
        space: the diagonal posterior Cholesky (noise included)."""
        loc_fn = self.th_location(prior=prior, noise=noise)
        sd_fn = self.th_kernel_sd(prior=prior, noise=True)
        mapping = self.f_mapping

        def fn(params, space, inputs, outputs, vector):
            mu = loc_fn(params, space, inputs, outputs, vector)
            sd = sd_fn(params, space, inputs, outputs, vector)
            tinv = to_num(mapping.inv(params, vector))
            logdet = mapping.logdet_dinv(params, vector)
            return warped_gaussian_logp_cho(vector, mu, torch.diag_embed(sd), tinv, logdet)

        return fn

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """``samples`` posterior (or prior) draws at the space, (m,
        samples): Cholesky-coloured standard normals pushed through the
        warping.  ``rng`` draws the normals: a numpy Generator (the JAX
        package's: the same seed gives the same normals; a fresh one when
        None) or a ``torch.Generator`` on ``settings.device``."""
        dev = device_statistics(self)
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        loc = dev.location(params, **kw)
        m = loc.shape[0]
        if isinstance(rng, torch.Generator):
            rand = torch.randn((m, samples), generator=rng, dtype=loc.dtype,
                               device=loc.device)
        else:
            rng = np.random.default_rng() if rng is None else rng
            rand = as_tensor(rng.standard_normal((m, samples)).astype(settings.floatx))
        latent = loc[:, None] + torch.matmul(dev.cholesky(params, **kw), rand)
        return self.f_mapping(self._tensor_params(self.params if params is None else params),
                              latent)

    def th_cross_mean(self, prior=False, noise=False, cross_kernel=None):
        """Posterior mean at the space through an explicit cross kernel
        (the signal kernel by default): m(s) + K_cross(s, X) K^{-1} (T^{-1}y
        - m(X))."""
        cross_kernel = self.f_kernel if cross_kernel is None else cross_kernel
        location = self.f_location

        def fn(params, space, inputs, outputs, vector):
            if prior:
                return location(params, space)
            cross = to_num(cross_kernel.cov(params, space, inputs))
            resid = self._latent_obs(params, outputs) - location(params, inputs)
            return location(params, space) + torch.matmul(
                cross, cho_solve(self._obs_chol(params, inputs), resid))

        return fn

    def predictor_iterative(self, params=None, rank=64, block=2048, cg_iters=200, tol=1e-6,
                            dtype=None):
        """Matrix-free serving for training sets too large to factor: one
        preconditioned-CG solve and a rank-``rank`` pivoted Cholesky, then
        every statistic from blocked cross grams — no O(n^3) factorization
        and no n x n matrix (:class:`~g3py_tpu_torch.models.predictor.
        IterativePredictor`).  ``dtype='float64'`` runs the whole solve in
        float64 (for near-interpolation grams beyond float32 CG's reach);
        the statistics come back in ``settings.floatx``."""
        from .predictor import IterativePredictor

        return IterativePredictor(self, params, rank=rank, block=block, cg_iters=cg_iters,
                                  tol=tol, dtype=dtype)

    def nll_iterative(self, params=None, rank=64, block=2048, cg_iters=100, probes=8,
                      lanczos_iters=25, seed=0):
        """Matrix-free negative loglikelihood for training sets too large to
        factor (:func:`~g3py_tpu_torch.ops.iterative.preconditioned_gp_nll`):
        the gram read lazily in (block, n) slabs, the quadratic form by
        preconditioned CG, the log det by batched SLQ, the gradient by the
        stochastic-trace backward — torch autograd of this trains the model
        with no n x n matrix in either pass.  ``seed`` as there (an int, a
        ``torch.Generator`` or a dict of the draws).

        Needs the noisy=True construction (the noise variance is the
        KernelNoise term's hyper) and no KernelNoise inside the signal
        kernel.  Includes the warping Jacobian, as ``loglike`` does (no hyper
        priors).  Returns ``(nll, info)``, tensors on the device."""
        from ..hypers import hval
        from ..hypers.kernels import KernelSum, KernelNoise
        from ..ops.iterative import preconditioned_gp_nll

        if params is None:
            params = self.params
        params = {k: as_tensor(v) for k, v in self.filter_params(params).items()}
        kn = self.f_kernel_noise
        if not (isinstance(kn, KernelSum) and isinstance(kn.k2, KernelNoise)):
            raise ValueError("nll_iterative needs the noisy=True "
                             "KernelSum(kernel, KernelNoise) construction")
        if _contains_kernel_noise(self.f_kernel):
            # KernelNoise adds 0 to every CROSS covariance: the slab matvec
            # would drop it from the quadratic form and the log det
            raise ValueError("nll_iterative does not support KernelNoise terms inside the "
                             "signal kernel (the lazy matvec sees only cross-covariances)")
        noise_var = hval(kn.k2.var, params)
        inputs = self._device_data("inputs")
        outputs = self._device_data("outputs")
        latent = self._latent_obs(params, outputs)
        mean = self.f_location(params, inputs)
        nll, info = preconditioned_gp_nll(
            self.f_kernel, params, inputs, latent, noise_var, rank=rank, block=block,
            cg_iters=cg_iters, probes=probes, lanczos_iters=lanczos_iters, seed=seed,
            mean=mean)
        # the warping Jacobian: loglike = log N(T^{-1}y) + log det dT^{-1}/dy
        return nll - self.f_mapping.logdet_dinv(params, outputs), info

    def _find_map_iterative(self, start=None, points=1, return_points=False, display=True,
                            max_iters=200, rank=64, block=2048, cg_iters=100, probes=8,
                            lanczos_iters=25, seed=0, loop="host", chunk=1,
                            linesearch_steps=None, dispatch_budget=None, **_):
        """MAP search on the matrix-free NLL plus the hyper priors
        (``find_MAP(engine='iterative')``), L-BFGS over its stochastic-trace
        gradient.  ``probes`` sets the trace estimator's bias, and so bounds
        the optimum it reaches.  ``loop='host'`` is scipy's L-BFGS-B with
        one value-and-gradient evaluation a call (the start point's repeat
        read from a memo); ``loop='device'`` is
        :func:`~g3py_tpu_torch.bayesian.optimize_jax.lbfgs_minimize_guarded`.
        Both read a point whose NLL is not finite or whose CG residual is
        above 5e-2 as 1e10 with a zero gradient.  ``chunk`` and
        ``dispatch_budget`` change nothing here.  The starts are ``start``
        (``params_default`` when None; a list of them) and, up to
        ``points``, ``params_random`` around the first (sigma 0.15, from
        ``np.random.default_rng(0)``)."""
        import scipy.optimize as spo
        from ..bayesian.optimize_jax import lbfgs_minimize_guarded

        reg = self.active
        if start is None:
            start = self.params_default
        starts = list(start) if isinstance(start, list) else [start]
        rng = np.random.default_rng(0)
        while len(starts) < points:
            starts.append(self.params_random(mean=starts[0], sigma=0.15, prop=True, rng=rng))
        prior_pure = self._logp_pure(prior=True)
        space, inputs, outputs = self._resolve_data(None, None, None)

        def objective(u):
            p = reg.array_to_dict_tensor(u)
            nll, info = self.nll_iterative(p, rank=rank, block=block, cg_iters=cg_iters,
                                           probes=probes, lanczos_iters=lanczos_iters, seed=seed)
            return nll - prior_pure(p, space, inputs, outputs), info["cg_rel_residual"]

        if loop == "device":
            u0s = np.stack([np.asarray(reg.dict_to_array(s), settings.floatx) for s in starts])
            pts, vals, iters = lbfgs_minimize_guarded(
                objective, u0s, max_iters=max_iters, chunk=chunk, display=display,
                linesearch_steps=linesearch_steps, dispatch_budget=dispatch_budget)
            results = []
            for i in range(len(vals)):
                if vals[i] >= 1e10:
                    print(f"start{i + 1}: never reached a trusted region (non-finite NLL or "
                          "CG residual > 5e-2) — dropped; raise cg_iters/rank or move the start")
                    continue
                if display:
                    print(f"start{i + 1} done (-logp): {vals[i]:.6g} ({int(iters[i])} iters)")
                results.append((f"iterative{i + 1}", float(vals[i]), reg.array_to_dict(pts[i])))
            if not results:
                raise ValueError(
                    "find_MAP(engine='iterative', loop='device'): every start point was "
                    "untrusted; raise cg_iters/rank/probes or provide a better start")
        elif loop == "host":
            memo = {}

            def f_and_g(u):
                key = u.tobytes()
                if key in memo:  # scipy re-evaluates the start point
                    return memo[key]
                ut = torch.as_tensor(u, dtype=settings.dtype,
                                     device=settings.device).requires_grad_(True)
                with torch.enable_grad():
                    v, resid = objective(ut)
                    (g,) = torch.autograd.grad(v, ut)
                v, g = float(v.detach()), g.detach().cpu().numpy().astype(np.float64)
                if not np.isfinite(v) or not np.all(np.isfinite(g)) or float(resid) > 5e-2:
                    # an overshoot into a numerically dead region, or a
                    # point where the CG solve is untrusted, reads as very
                    # bad: unguarded, L-BFGS chases the estimator's
                    # breakdown to fake optima
                    out = (1e10, np.zeros_like(g))
                else:
                    out = (v, g)
                memo.clear()  # the most recent point only
                memo[key] = out
                return out

            results = []
            for i, s in enumerate(starts, start=1):
                u0 = np.asarray(reg.dict_to_array(s), np.float64)
                v0 = f_and_g(u0)[0]
                if v0 >= 1e10:
                    # a zero gradient at an untrusted start would make
                    # L-BFGS-B a silent no-op
                    print(f"start{i}: untrusted at the start point (non-finite NLL or CG "
                          "residual > 5e-2) — skipped; raise cg_iters/rank or move the start")
                    continue
                if display:
                    print(f"start{i} (-logp): {v0:.6g}")
                res = spo.minimize(f_and_g, u0, jac=True, method="L-BFGS-B",
                                   options={"maxiter": max_iters})
                results.append((f"iterative{i}", float(res.fun),
                                reg.array_to_dict(np.asarray(res.x, settings.floatx))))
                if display:
                    print(f"start{i} done (-logp): {res.fun:.6g}")
            if not results:
                raise ValueError(
                    "find_MAP(engine='iterative'): every start point was untrusted "
                    "(non-finite NLL or CG residual > 5e-2); raise cg_iters/rank/probes or "
                    "provide a better start")
        else:
            raise ValueError(f"unknown loop {loop!r} ('host' | 'device')")
        results.sort(key=lambda t: t[1])
        best = results[0][2]
        if return_points:
            return best, [(n_, -v, p) for n_, v, p in results]
        return best

    def nll_distributed(self, params=None, mesh=None, block=None, axis="dp"):
        """Band-sharded exact negative loglikelihood (no hyper priors; the
        mean and the warping Jacobian included, as ``loglike``): every rank
        of the mesh builds, factors and differentiates its own (n/D, n) row
        band of the gram (:meth:`_distributed_qld`); no rank holds the n x n
        gram, in the forward or the backward.  Every rank calls it with the
        same params and gets the same value; autograd through it gives the
        same gradient on every rank.  Needs noisy=True and n divisible by
        the mesh."""
        qld = self._distributed_qld(mesh=mesh, block=block, axis=axis)
        params, x, outputs, resid = self._distributed_resid(params)
        quad, logdet_half = qld(params, x, resid)
        val = 0.5 * quad + logdet_half + 0.5 * len(resid) * LOG2PI
        # the warping Jacobian: loglike = log N(T^{-1}y) + log det dT^{-1}/dy
        return val - self.f_mapping.logdet_dinv(params, outputs)

    def predictor_distributed(self, params=None, mesh=None, block=None, axis="dp"):
        """Band-sharded serving, the counterpart of
        ``find_MAP(engine='distributed')``: the gram is factored once by the
        band Cholesky and stays split over the ranks; a query batch costs a
        cross band, a band solve and two psums
        (:class:`~g3py_tpu_torch.models.predictor.DistributedPredictor`)."""
        from .predictor import DistributedPredictor

        return DistributedPredictor(self, params, mesh=mesh, block=block, axis=axis)

    def _quantile_p(self, q):
        """Latent-space quantile coefficient: quantile = T(mu + p * sd).  Held
        at float32 precision, as the JAX package holds it."""
        return float(np.float32(NormalDist().inv_cdf(q)))

    def _quantile_pair(self, params, inputs, prior=False, batch=False):
        """(up, down) latent quantile coefficients at 97.5% and 2.5%: each
        held at float32 as ``quantiler`` holds it, or with ``batch``
        +-z_0.975 in ``settings.floatx``, as the JAX package's
        ``batch_predict`` holds them."""
        if batch:
            p = float(np.asarray(NormalDist().inv_cdf(0.975), dtype=settings.floatx))
            return p, -p
        return self._quantile_p(0.975), self._quantile_p(0.025)

    def _batch_latent_rand(self, rows, n, rng, space=None, inputs=None, outputs=None,
                           prior=False, noise=False):
        """Per-row latent innovations (R, n): standard normals from ``rng``."""
        return rng.standard_normal((len(rows), n)).astype(settings.floatx)

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """Analytic quantile T(mu + z_q sigma)."""
        dev = device_statistics(self)
        p = self._quantile_p(q)
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        loc = dev.location(params, **kw)
        sd = dev.kernel_sd(params, **kw)
        return dev.mapping(params, space=space, inputs=inputs, outputs=outputs,
                            vector=loc + p * sd, prior=prior, noise=noise)


class WarpedGaussianProcess(GaussianProcess):
    """GP with non-analytic warped moments by Gauss-Hermite quadrature."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "WGP")
        super().__init__(*args, **kwargs)

    def _hermite_moments(self, params, mu, sd, n=None):
        """(E[T], Var[T]) over N(mu, sd^2) (:func:`~g3py_tpu_torch.ops.
        quadrature.hermite_moments`, the centred variance)."""
        n = settings.quadrature_degree if n is None else n
        return hermite_moments(lambda v: self.f_mapping(params, v), mu, sd, n)

    def th_mean(self, prior=False, noise=False, simulations=None, n=None):
        n = settings.quadrature_degree if n is None else n
        loc_fn = self.th_location(prior=prior, noise=noise)
        sd_fn = self.th_kernel_sd(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            mu = loc_fn(params, space, inputs, outputs, vector)
            sd = sd_fn(params, space, inputs, outputs, vector)
            return gauss_hermite(lambda v: self.f_mapping(params, v), mu, sd, n=n)

        return fn

    def th_variance(self, prior=False, noise=False, simulations=None, n=None):
        loc_fn = self.th_location(prior=prior, noise=noise)
        sd_fn = self.th_kernel_sd(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            mu = loc_fn(params, space, inputs, outputs, vector)
            sd = sd_fn(params, space, inputs, outputs, vector)
            return self._hermite_moments(params, mu, sd, n)[1]

        return fn

    def th_covariance(self, prior=False, noise=False):
        return None

    def _warped_moments(self, params, loc, var):
        return self._hermite_moments(params, loc, torch.sqrt(var))
