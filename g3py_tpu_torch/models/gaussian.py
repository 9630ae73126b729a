"""GaussianProcess / WarpedGaussianProcess (the PyTorch counterpart of
:mod:`g3py_tpu.models.gaussian`, subset).

The GP observed density is the warped multivariate normal

  logp = -n/2 log 2pi - 1/2 |L^{-1}(T^{-1}y - mu)|^2 - sum log diag L
         + log|det dT^{-1}(y)|

with four guards falling to -1e30; quantiles are analytic
(``T(mu + z_q sigma)``); WGP moments are Gauss-Hermite quadratures of T and
T^2 over the latent gaussian.
"""

import math
from statistics import NormalDist

import numpy as np
import torch

from ..config import settings
from ..ops.guards import to_num, to_cov
from ..ops.linalg import mvn_quad_logdet
from ..ops.quadrature import gauss_hermite
from .elliptical import EllipticalProcess

__all__ = ["GaussianProcess", "WarpedGaussianProcess"]

LOG2PI = math.log(2.0 * math.pi)


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
            guard = settings.logp_guard
            bad = (ok == 0) | ~torch.isfinite(quad) | ~torch.isfinite(logdet_map)
            return torch.where(bad, torch.full_like(r, guard),
                               to_num(r, nan=guard, neginf=guard))

        return fn

    def _quantile_p(self, q):
        """Latent-space quantile coefficient: quantile = T(mu + p * sd).  Held
        at float32 precision, as the JAX package holds it."""
        return float(np.float32(NormalDist().inv_cdf(q)))

    def _batch_quantile_z(self):
        """(up, down) latent quantile coefficients of the batched statistics:
        +-z_0.975 in ``settings.floatx``, as the JAX package's
        ``batch_predict`` holds them."""
        p = float(np.asarray(NormalDist().inv_cdf(0.975), dtype=settings.floatx))
        return p, -p

    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False):
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
        """(E[T], E[T^2]) over N(mu, sd^2)."""
        n = settings.quadrature_degree if n is None else n
        m1 = gauss_hermite(lambda v: self.f_mapping(params, v), mu, sd, n=n)
        m2 = gauss_hermite(lambda v: self.f_mapping(params, v) ** 2, mu, sd, n=n)
        return m1, m2

    def th_mean(self, prior=False, noise=False, n=None):
        n = settings.quadrature_degree if n is None else n
        loc_fn = self.th_location(prior=prior, noise=noise)
        sd_fn = self.th_kernel_sd(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            mu = loc_fn(params, space, inputs, outputs, vector)
            sd = sd_fn(params, space, inputs, outputs, vector)
            return gauss_hermite(lambda v: self.f_mapping(params, v), mu, sd, n=n)

        return fn

    def th_variance(self, prior=False, noise=False, n=None):
        loc_fn = self.th_location(prior=prior, noise=noise)
        sd_fn = self.th_kernel_sd(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            mu = loc_fn(params, space, inputs, outputs, vector)
            sd = sd_fn(params, space, inputs, outputs, vector)
            m1, m2 = self._hermite_moments(params, mu, sd, n)
            return m2 - m1 ** 2

        return fn

    def _warped_moments(self, params, loc, var):
        m1, m2 = self._hermite_moments(params, loc, torch.sqrt(var))
        return m1, m2 - m1 ** 2
