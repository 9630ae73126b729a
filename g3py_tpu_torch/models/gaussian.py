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

from ..config import settings, as_tensor
from ..ops.guards import to_num, to_cov
from ..ops.linalg import mvn_quad_logdet, mvn_loo, solve_lower_triangular
from ..ops.quadrature import gauss_hermite, hermite_moments
from .elliptical import EllipticalProcess

__all__ = ["GaussianProcess", "WarpedGaussianProcess", "warped_gaussian_logp_cho"]

LOG2PI = math.log(2.0 * math.pi)


def _guarded(r, bad):
    guard = settings.logp_guard
    return torch.where(bad, torch.full_like(r, guard), to_num(r, nan=guard, neginf=guard))


def warped_gaussian_logp_cho(value, mu, cho, mapping_inv_value, logdet_dinv):
    """logp of a warped gaussian given a Cholesky factor ``cho`` (full or
    diagonal) of its dispersion; ``mapping_inv_value`` and ``logdet_dinv``
    are the warping's pullback of ``value`` and its log-Jacobian.  A
    non-finite residual, Jacobian, factor or whitened residual, or a
    NaN/-inf result, gives ``settings.logp_guard``."""
    delta = mapping_inv_value - mu
    lcho = solve_lower_triangular(cho, delta)
    r = (-0.5 * cho.shape[0] * LOG2PI - 0.5 * torch.dot(lcho, lcho)
         - torch.log(torch.diagonal(cho)).sum() + logdet_dinv)
    bad = (~torch.isfinite(delta).all() | ~torch.isfinite(logdet_dinv)
           | ~torch.isfinite(cho).all() | ~torch.isfinite(lcho).all())
    return _guarded(r, bad)


class GaussianProcess(EllipticalProcess):
    """Exact (optionally warped-observation) Gaussian process regression."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "GP")
        super().__init__(*args, **kwargs)

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
            return warped_gaussian_logp_cho(vector, mu, torch.diag(sd), tinv, logdet)

        return fn

    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """``samples`` posterior (or prior) draws at the space, (m,
        samples): Cholesky-coloured standard normals pushed through the
        warping.  ``rng`` draws the normals: a numpy Generator (the JAX
        package's: the same seed gives the same normals; a fresh one when
        None) or a ``torch.Generator`` on ``settings.device``."""
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        loc = self.location(params, **kw)
        m = loc.shape[0]
        if isinstance(rng, torch.Generator):
            rand = torch.randn((m, samples), generator=rng, dtype=loc.dtype,
                               device=loc.device)
        else:
            rng = np.random.default_rng() if rng is None else rng
            rand = as_tensor(rng.standard_normal((m, samples)).astype(settings.floatx))
        latent = loc[:, None] + torch.matmul(self.cholesky(params, **kw), rand)
        return self.f_mapping(self._tensor_params(self.params if params is None else params),
                              latent)

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

    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """Analytic quantile T(mu + z_q sigma)."""
        p = self._quantile_p(q)
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        loc = self.location(params, **kw)
        sd = self.kernel_sd(params, **kw)
        return self.mapping(params, space=space, inputs=inputs, outputs=outputs,
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
