"""Student-t processes (TP / WTP) and the warped multivariate-t density (the
PyTorch counterpart of :mod:`g3py_tpu.models.studentt`).

A Freedom degree hyper nu (default bound 2 + n_obs) makes the observed
density the (nu-2)-normalized multivariate t

  logp = -(nu+n)/2 log(1 + beta/(nu-2)) + lgamma((nu+n)/2) - lgamma(nu/2)
         - n/2 log((nu-2) pi) - 1/2 log det K + log|det dT^{-1}(y)|

with beta = (T^{-1}y - m)' K^{-1} (T^{-1}y - m) from ``mvn_quad_logdet``
(K1 and K2 on the card, the analytic backward), and its gaussian limit for
nu >= 1e6.  A params dict of R rows gives R values from one batched K1 and
one batched K2 call, as for the GP.  The posterior has nu + n degrees of
freedom and a covariance scaled by (nu + beta - 2)/(nu + n - 2); in the
factored path beta is the state's |z|^2.  Quantiles are Student-t
(``scipy.stats.t.ppf`` on the host) on the unscaled latent sd, as in the
JAX package; samples mix Cholesky-coloured normals with inverse-gamma
draws from numpy's generators, as the JAX package draws them.
"""

import math

import numpy as np
import torch
from scipy import stats

from ..config import settings, as_tensor, host_statistic, device_statistics
from ..hypers import Freedom
from ..ops.guards import to_num, to_cov
from ..ops.linalg import mvn_quad_logdet, solve_lower_triangular
from ..ops.quadrature import gauss_hermite, hermite_moments
from ..ops.special import gammaln
from .elliptical import EllipticalProcess, STATE_OBS_Z
from .gaussian import _any_nonfinite, _guarded, _masked_parts

__all__ = ["StudentTProcess", "WarpedStudentTProcess",
           "warped_studentt_logp_cho", "WarpedStudentTDistribution"]


def _per_row(v, x):
    """A per-row value (``()`` or ``(R,)``) shaped to broadcast over ``x``,
    whose leading axis is the row axis when ``v`` has one."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def _t_terms(nu, n, beta):
    """The beta term and the normalization of the (nu-2)-normalized
    multivariate t over n points (the gaussian normalization for nu >= 1e6)."""
    r1 = -0.5 * (nu + n) * torch.log1p(beta / (nu - 2.0))
    student = (gammaln((nu + n) * 0.5) - gammaln(nu * 0.5)
               - 0.5 * n * torch.log((nu - 2.0) * math.pi))
    gaussian_limit = (-0.5 * math.log(2.0 * math.pi) * n) * torch.ones_like(student)
    return r1 + torch.where(nu >= 1e6, gaussian_limit, student)


def warped_studentt_logp_cho(value, mu, cho, freedom, mapping_inv_value, logdet_dinv):
    """Multivariate-t logp given the Cholesky factor ``cho`` of its scale
    matrix (the covariance parameterization, with the (nu-2)
    normalization); ``mapping_inv_value`` and ``logdet_dinv`` are the
    warping's pullback of ``value`` and its log-Jacobian.  A non-finite
    residual, Jacobian, factor or whitened residual, or a NaN/-inf result,
    gives ``settings.logp_guard``."""
    delta = mapping_inv_value - mu
    lcho = solve_lower_triangular(cho, delta)
    beta = (lcho * lcho).sum(dim=-1)
    r = (_t_terms(torch.as_tensor(freedom, dtype=beta.dtype, device=beta.device),
                  cho.shape[-1], beta)
         - torch.log(torch.diagonal(cho, dim1=-2, dim2=-1)).sum(dim=-1) + logdet_dinv)
    return _guarded(r, _any_nonfinite(delta, logdet_dinv, cho, lcho))


class WarpedStudentTDistribution:
    """Namespace kept for the reference's API."""

    logp_cho = staticmethod(warped_studentt_logp_cho)


class StudentTProcess(EllipticalProcess):
    """Student-t process regression (optionally warped observations)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "TP")
        if kwargs.get("degree") is None:
            kwargs["degree"] = Freedom()
        super().__init__(*args, **kwargs)

    def th_define_process(self):
        self.distribution = WarpedStudentTDistribution

    def th_loglike_fn(self):
        """Observed-data loglikelihood: the warped multivariate t over the
        prior moments of the inputs, through ``mvn_quad_logdet``.  A failed
        factorization, a non-finite quadratic form or Jacobian, or a
        NaN/-inf result gives ``settings.logp_guard``."""
        mapping = self.f_mapping
        location = self.f_location
        degree = self.f_degree
        kernel_noise = self.f_kernel_noise

        def fn(params, space, inputs, outputs):
            mu = location(params, inputs)
            cov = to_cov(kernel_noise.cov(params, inputs))
            tinv = to_num(mapping.inv(params, outputs))
            logdet_map = mapping.logdet_dinv(params, outputs)
            nu = degree(params)
            beta, logdet_half, ok = mvn_quad_logdet(cov, tinv - mu)
            r = _t_terms(nu, inputs.shape[0], beta) - logdet_half + logdet_map
            return _guarded(r, (ok == 0) | ~torch.isfinite(beta) | ~torch.isfinite(logdet_map))

        return fn

    def nll_distributed(self, params=None, mesh=None, block=None, axis="dp"):
        """Band-sharded exact Student-t negative loglikelihood: the
        multivariate-t terms of ``th_loglike_fn`` over the quadratic form and
        log det of the band-sharded gram (``_distributed_qld``); nu and the
        gammaln terms are replicated scalars.  The GP version's contract
        (noisy=True, n divisible by the mesh, the warping Jacobian
        included, no priors)."""
        qld = self._distributed_qld(mesh=mesh, block=block, axis=axis)
        params, x, outputs, resid = self._distributed_resid(params)
        beta, logdet_half = qld(params, x, resid)
        ll = (_t_terms(self.f_degree(params), len(resid), beta) - logdet_half
              + self.f_mapping.logdet_dinv(params, outputs))
        return -ll

    def th_loglike_masked_fn(self):
        """Masked-observation multivariate-t loglike (the gaussian version's
        identity-row gram surgery, :meth:`GaussianProcess.th_loglike_masked_fn`):
        n becomes n_eff = sum(w) in every density term, so one shape serves
        every split — exactly the submatrix model's loglike at the same
        ``degree``."""
        mapping = self.f_mapping
        location = self.f_location
        degree = self.f_degree
        kernel_noise = self.f_kernel_noise

        def fn(params, inputs, outputs, w):
            covw, resid, logdet_map, n_eff = _masked_parts(mapping, location, kernel_noise,
                                                           params, inputs, outputs, w)
            beta, logdet_half, ok = mvn_quad_logdet(covw, resid)
            r = _t_terms(degree(params), n_eff, beta) - logdet_half + logdet_map
            return _guarded(r, (ok == 0) | ~torch.isfinite(beta) | ~torch.isfinite(logdet_map))

        return fn

    def fit_splits(self, masks, start=None, points=4, max_iters=200, tol=1e-5,
                   noise_mult=0.2, seed=0, shard=False, mesh=None, pair_chunk=None):
        """On-device (split x start) MAP fan-out (:mod:`g3py_tpu_torch.bayesian.fanout`)."""
        from ..bayesian.fanout import fit_splits as _fit_splits
        return _fit_splits(self, masks, start=start, points=points, max_iters=max_iters,
                           tol=tol, noise_mult=noise_mult, seed=seed, shard=shard, mesh=mesh,
                           pair_chunk=pair_chunk)

    # -- posterior scaling -----------------------------------------------------
    def _scaling_fn(self, prior):
        """(nu + beta - 2)/(nu + n - 2), beta the whitened residual's squared
        norm (the state's z when one rides in the params); 1 on the prior."""
        if prior:
            return lambda params, space, inputs, outputs, vector: torch.ones(
                (), dtype=settings.dtype, device=settings.device)
        location = self.f_location
        mapping = self.f_mapping
        degree = self.f_degree

        def fn(params, space, inputs, outputs, vector):
            if STATE_OBS_Z in params:
                alpha = params[STATE_OBS_Z]
            else:
                chol = self._obs_chol(params, inputs)
                resid = to_num(mapping.inv(params, outputs)) - location(params, inputs)
                alpha = solve_lower_triangular(chol, resid)
            beta = (alpha * alpha).sum(dim=-1)
            nu = degree(params)
            return (nu + beta - 2.0) / (nu + inputs.shape[0] - 2.0)

        return fn

    def _scaled(self, base, prior):
        scale = self._scaling_fn(prior)

        def fn(params, space, inputs, outputs, vector):
            out = base(params, space, inputs, outputs, vector)
            return out * _per_row(scale(params, space, inputs, outputs, vector), out)

        return fn

    def th_variance(self, prior=False, noise=False, simulations=None):
        return self._scaled(super().th_variance(prior=prior, noise=noise), prior)

    def th_covariance(self, prior=False, noise=False):
        base = super().th_covariance(prior=prior, noise=noise)
        scale = self._scaling_fn(prior)

        def fn(params, space, inputs, outputs, vector):
            out = base(params, space, inputs, outputs, vector)
            s = scale(params, space, inputs, outputs, vector)
            return out * s.reshape(s.shape + (1, 1))

        return fn

    def _moments_fn(self, params, inputs, outputs, prior=False):
        scale = self._scaling_fn(prior)(params, None, inputs, outputs, None)
        return lambda loc, var: (self.f_mapping(params, loc), var * _per_row(scale, var))

    def th_logpredictive(self, prior=False, noise=False):
        """Independent-marginal Student-t log predictive density of
        ``vector`` (diagonal scale, noise included)."""
        loc_fn = self.th_location(prior=prior, noise=noise)
        sd_fn = self.th_kernel_sd(prior=prior, noise=True)
        free_fn = self.th_freedom(prior=prior, noise=noise)
        scale = self._scaling_fn(prior)
        mapping = self.f_mapping

        def fn(params, space, inputs, outputs, vector):
            mu = loc_fn(params, space, inputs, outputs, vector)
            sd = sd_fn(params, space, inputs, outputs, vector) * torch.sqrt(
                scale(params, space, inputs, outputs, vector))
            nu = free_fn(params, space, inputs, outputs, vector)
            tinv = to_num(mapping.inv(params, vector))
            logdet = mapping.logdet_dinv(params, vector)
            return warped_studentt_logp_cho(vector, mu, torch.diag_embed(sd), nu, tinv, logdet)

        return fn

    # -- quantiles and samples (host scipy, as the JAX package) ---------------
    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """T(mu + t_q sd), t_q the Student-t quantile at the posterior df
        (held at float32, as the JAX package holds it) and sd the unscaled
        latent sd."""
        dev = device_statistics(self)
        p = self._quantile_p(params, q, prior=prior, noise=noise, space=space,
                             inputs=inputs, outputs=outputs)
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        latent = dev.location(params, **kw) + p * dev.kernel_sd(params, **kw)
        return dev.mapping(params, space=space, inputs=inputs, outputs=outputs,
                            vector=latent)

    def _quantile_p(self, params, q, prior=False, noise=False, space=None, inputs=None,
                    outputs=None):
        """Student-t latent quantile coefficient at the posterior df."""
        df = float(self.freedom(params, space=space, inputs=inputs, outputs=outputs,
                                prior=prior, noise=noise))
        return float(np.float32(stats.t.ppf(q, df=df)))

    def _quantile_pair(self, params, inputs, prior=False, batch=False):
        """(up, down) latent quantile coefficients at 97.5% and 2.5% at the
        df of ``params`` (a row's own for a dict of rows): each held at
        float32, or with ``batch`` +-t_0.975 in ``settings.floatx``, (R, 1)
        for R rows, as the JAX package's ``batch_predict`` holds them."""
        df = self.th_freedom(prior=prior)(params, None, inputs, None, None)
        df64 = df.detach().cpu().numpy().astype(np.float64)
        if batch:
            p = as_tensor(stats.t.ppf(0.975, df=df64).astype(settings.floatx))
            p = p.reshape(p.shape + (1,)) if p.ndim else p
            return p, -p
        return (float(np.float32(stats.t.ppf(0.975, df=df64))),
                float(np.float32(stats.t.ppf(0.025, df=df64))))

    def _freedom_rows(self, rows, space=None, inputs=None, outputs=None, prior=False):
        """Degrees of freedom of every row of an (R, ndim) matrix of
        unconstrained rows, float64 on the host."""
        if inputs is None and not self.is_observed:
            prior = True
        _, inputs, _ = self._resolve_data(space, inputs, outputs)
        params = self.active.array_to_dict_tensor(as_tensor(np.asarray(rows)))
        df = self.th_freedom(prior=prior)(params, None, inputs, None, None)
        return df.detach().cpu().numpy().astype(np.float64)

    def _batch_quantile_p(self, q, rows, space=None, inputs=None, outputs=None,
                          prior=False, noise=False):
        """Per-row latent quantile coefficient, (R,) in ``settings.floatx``."""
        df = self._freedom_rows(rows, space, inputs, outputs, prior)
        return stats.t.ppf(q, df=df).astype(settings.floatx)

    def _batch_latent_rand(self, rows, n, rng, space=None, inputs=None, outputs=None,
                           prior=False, noise=False):
        """Per-row latent innovations (R, n): standard normals from ``rng``
        times one inverse-gamma draw a row (scipy, from ``rng``)."""
        df = self._freedom_rows(rows, space, inputs, outputs, prior)
        rand = rng.standard_normal((len(rows), n))
        scale = stats.invgamma.rvs(a=df / 2, scale=(df - 2) / 2, random_state=rng)
        return (rand * np.asarray(scale).reshape(-1, 1)).astype(settings.floatx)

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """``samples`` draws at the space, (m, samples): standard normals
        from ``rng`` (numpy's Generator; a fresh one when None) times one
        inverse-gamma draw a sample (``scipy.stats.invgamma`` on numpy's
        global generator, as the JAX package draws it), coloured by the
        latent Cholesky factor and pushed through the warping."""
        dev = device_statistics(self)
        if space is None:
            space = self.space
        if rng is None:
            rng = np.random.default_rng()
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        free = float(dev.freedom(params, **kw))
        rand = rng.standard_normal((len(space), samples)).astype(settings.floatx)
        rand = rand * stats.invgamma.rvs(a=free / 2, scale=(free - 2) / 2,
                                         size=samples).astype(settings.floatx)
        loc = dev.location(params, **kw)
        latent = loc[:, None] + torch.matmul(dev.cholesky(params, **kw), as_tensor(rand))
        return self.f_mapping(self._tensor_params(self.params if params is None else params),
                              latent)


class WarpedStudentTProcess(StudentTProcess):
    """TP with Gauss-Hermite warped moments over the unscaled latent sd, as
    the JAX package computes them (the variance is the centred second
    moment, :func:`~g3py_tpu_torch.ops.quadrature.hermite_moments`)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "WTP")
        super().__init__(*args, **kwargs)

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
        n = settings.quadrature_degree if n is None else n
        loc_fn = self.th_location(prior=prior, noise=noise)
        sd_fn = self.th_kernel_sd(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            mu = loc_fn(params, space, inputs, outputs, vector)
            sd = sd_fn(params, space, inputs, outputs, vector)
            return hermite_moments(lambda v: self.f_mapping(params, v), mu, sd, n)[1]

        return fn

    def th_covariance(self, prior=False, noise=False):
        return None

    def _moments_fn(self, params, inputs, outputs, prior=False):
        return lambda loc, var: hermite_moments(lambda v: self.f_mapping(params, v), loc,
                                                torch.sqrt(var), settings.quadrature_degree)

    gauss_hermite = staticmethod(gauss_hermite)
