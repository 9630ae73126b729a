"""Copula processes — a latent correlation and marginal densities (the
PyTorch counterpart of :mod:`g3py_tpu.models.copula`).

  y_i = F_i^{-1}( Phi(z_i) ),   z ~ N(0, R(x))

with R the correlation-normalized kernel gram (K1 on the card) and F_i the
per-point marginal CDF of a :class:`~g3py_tpu_torch.models.marginal.
Density`.  The observed density is the gaussian-copula term (one K2
factorization of R) plus the marginal log-densities:

  logp = -1/2 z' R^{-1} z + 1/2 z'z - sum log diag chol(R) + sum log f_i(y_i)

with z = Phi^{-1}(F(y)).  :class:`CopulaStudentTProcess` swaps the latent
gaussian for a multivariate-t copula with a Freedom hyper.  The latent
posterior is gaussian; quantiles and draws go through the marginal ppf on
the host (scipy), as in the JAX package, and the mean and std are
Monte-Carlo over draws from numpy's generator.
"""

import numpy as np
import torch
from scipy import stats

from ..config import settings, as_tensor, host_statistic, device_statistics
from ..hypers import Freedom
from ..hypers.kernels import KernelSum, KernelNoise
from ..ops.guards import to_cov, to_num
from ..ops.linalg import safe_cholesky, solve_lower_triangular, cho_solve
from ..ops.special import ndtri, gammaln
from .stochastic import StochasticProcess, _statistic
from .marginal import MarginalProcess

__all__ = ["CopulaProcess", "CopulaGaussianProcess", "CopulaStudentTProcess",
           "TransformedStudentTProcess"]

# the CDF's clip, in float32 as the JAX package rounds it, and the host
# clip of the quantile push (float64 there)
_EPS = float(np.float32(1e-6))
_HI32 = float(np.float32(1.0) - np.float32(1e-6))


def _guarded(r, z):
    guard = settings.logp_guard
    return torch.where(~torch.isfinite(z).all(), torch.full_like(r, guard),
                       to_num(r, nan=guard, neginf=guard))


class CopulaProcess(StochasticProcess):
    """Latent-correlation process with arbitrary marginals: a Kernel for the
    latent correlation and a ``marginal`` (a Density, or a MarginalProcess
    whose density is taken)."""

    _batched_rows = False
    _mc_moments = True

    def __init__(self, space=None, kernel=None, marginal=None, noisy=True, var_noise=None,
                 *args, **kwargs):
        if isinstance(marginal, MarginalProcess):
            marginal = marginal.f_density
        self.f_density = marginal
        self.f_kernel = kernel
        if noisy:
            self.f_kernel_noise = KernelSum(self.f_kernel,
                                            KernelNoise(name="Noise", var=var_noise))
        else:
            self.f_kernel_noise = self.f_kernel
        kwargs.setdefault("name", "CP")
        super().__init__(space, *args, **kwargs)

    def _components(self):
        return [self.f_kernel_noise, self.f_density]

    def _check_hypers(self):
        self.f_kernel_noise.check_dims(self.inputs)
        self.f_density.check_dims(self.inputs)
        self.f_kernel_noise.check_hypers(self.name + "_")
        self.f_density.check_hypers(self.name + "_")

    def default_hypers(self):
        x, y = self.inputs, self.outputs
        out = {}
        out.update(self.f_kernel_noise.default_hypers_dims(x, y))
        out.update(self.f_density.default_hypers_dims(x, y))
        return out

    # -- latent plumbing ----------------------------------------------------------
    def _correlation(self, params, x1, x2=None):
        """Correlation-normalized kernel gram.  The square form takes its
        diagonal from the gram itself (the JAX package builds the gram a
        second time for it, which XLA merges; here it would be a second
        K1 launch)."""
        k12 = self.f_kernel_noise.cov(params, x1, x2)
        if x2 is None:
            d1 = torch.sqrt(torch.diagonal(k12))
            return to_cov(k12 / (d1[:, None] * d1[None, :]))
        d1 = torch.sqrt(torch.diagonal(self.f_kernel_noise.cov(params, x1)))
        d2 = torch.sqrt(torch.diagonal(self.f_kernel_noise.cov(params, x2)))
        return k12 / (d1[:, None] * d2[None, :])

    def _latent_z(self, params, inputs, outputs):
        u = torch.clamp(self.f_density.cdf(params, inputs, outputs), _EPS, _HI32)
        return ndtri(u)

    def th_loglike_fn(self):
        density = self.f_density

        def fn(params, space, inputs, outputs):
            z = self._latent_z(params, inputs, outputs)
            chol = safe_cholesky(self._correlation(params, inputs))
            w = solve_lower_triangular(chol, z)
            copula = (-0.5 * torch.dot(w, w) + 0.5 * torch.dot(z, z)
                      - torch.log(torch.diagonal(chol)).sum())
            return _guarded(copula + density.logp(params, inputs, outputs), z)

        return fn

    # -- latent posterior -----------------------------------------------------------
    def _latent_posterior(self, params, space, inputs, outputs):
        """Gaussian posterior (mean, sd) of z(space) given z(inputs)."""
        z = self._latent_z(params, inputs, outputs)
        chol = safe_cholesky(self._correlation(params, inputs))
        cross = to_num(self._correlation(params, space, inputs))
        mu = torch.matmul(cross, cho_solve(chol, z))
        v = solve_lower_triangular(chol, cross.T)
        var = torch.clamp(1.0 - (v * v).sum(dim=0), min=0.0)
        return mu, torch.sqrt(var)

    def th_location(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return torch.zeros((space.shape[0],), dtype=settings.dtype,
                                   device=space.device)
        else:
            def fn(params, space, inputs, outputs, vector):
                return self._latent_posterior(params, space, inputs, outputs)[0]
        return fn

    def th_kernel_sd(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return torch.ones((space.shape[0],), dtype=settings.dtype,
                                  device=space.device)
        else:
            def fn(params, space, inputs, outputs, vector):
                return self._latent_posterior(params, space, inputs, outputs)[1]
        return fn

    location = _statistic("th_location", "Latent posterior mean.")
    kernel_sd = _statistic("th_kernel_sd", "Latent posterior standard deviation.")

    # -- host-side prediction -------------------------------------------------------
    def _push_quantile(self, params, space, latent):
        """F^{-1}(Phi(latent)) at the space, through the marginal's ppf on
        the host; an (m, S) ``latent`` goes through as (S, m), each row
        against the m marginals."""
        u = np.clip(stats.norm.cdf(latent.detach().cpu().numpy()), _EPS, 1 - _EPS)
        out = self.f_density.ppf(self._tensor_params(params), self._space_tensor(space), u.T)
        return as_tensor(np.asarray(out).T.astype(settings.floatx))

    def _space_tensor(self, space):
        return self._resolve_data(None if space is None or space is self._space else space,
                                  None, None)[0]

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None, rng=None):
        """F^{-1}(Phi(mu + z_q sd)) of the latent posterior."""
        dev = device_statistics(self)
        if params is None:
            params = self.params
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        latent = (dev.location(params, **kw)
                  + float(np.float32(stats.norm.ppf(q))) * dev.kernel_sd(params, **kw))
        return self._push_quantile(params, space, latent)

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """``samples`` draws at the space, (m, samples): latent posterior
        draws (numpy standard normals from ``rng``, one length-m vector a
        sample in turn, as the JAX package draws them) pushed through the
        marginal's ppf."""
        dev = device_statistics(self)
        if params is None:
            params = self.params
        if rng is None:
            rng = np.random.default_rng()
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        loc = dev.location(params, **kw)
        sd = dev.kernel_sd(params, **kw)
        rand = as_tensor(rng.standard_normal((samples, loc.shape[0])).astype(settings.floatx))
        return self._push_quantile(params, space, loc[:, None] + sd[:, None] * rand.T)

    def _mc_draws(self, params, space, inputs, outputs, prior, noise, simulations, rng):
        samples = simulations if isinstance(simulations, int) else settings.mc_simulations
        return device_statistics(self).sampler(params, space, inputs, outputs, samples=samples,
                                               prior=prior, noise=noise, rng=rng)

    @host_statistic
    def mean(self, params=None, space=None, inputs=None, outputs=None, prior=False,
             noise=False, simulations=None, rng=None, **kwargs):
        """Monte-Carlo mean through the copula push-forward (an int
        ``simulations`` draws; anything else draws ``settings.mc_simulations``)."""
        return self._mc_draws(params, space, inputs, outputs, prior, noise, simulations,
                              rng).mean(dim=1)

    @host_statistic
    def median(self, params=None, space=None, inputs=None, outputs=None, prior=False,
               noise=False, simulations=None, rng=None, **kwargs):
        return device_statistics(self).quantiler(params, space, inputs, outputs, q=0.5,
                                                 prior=prior, noise=noise)

    @host_statistic
    def std(self, params=None, space=None, inputs=None, outputs=None, prior=False,
            noise=False, simulations=None, rng=None, **kwargs):
        return self._mc_draws(params, space, inputs, outputs, prior, noise, simulations,
                              rng).std(dim=1, unbiased=False)

    @host_statistic
    def variance(self, params=None, space=None, inputs=None, outputs=None, prior=False,
                 noise=False, simulations=None, rng=None, **kwargs):
        return device_statistics(self).std(params, space, inputs, outputs, prior=prior,
                                           noise=noise, simulations=simulations, rng=rng) ** 2


class CopulaGaussianProcess(CopulaProcess):
    """Gaussian copula with arbitrary marginals."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "CGP")
        super().__init__(*args, **kwargs)


class CopulaStudentTProcess(CopulaProcess):
    """Student-t copula: a latent multivariate t with a Freedom hyper (its
    default is the prior's test value, as in the JAX package)."""

    def __init__(self, *args, degree=None, **kwargs):
        self.f_degree = degree if degree is not None else Freedom()
        kwargs.setdefault("name", "CSTP")
        super().__init__(*args, **kwargs)

    def _components(self):
        return super()._components() + [self.f_degree]

    def _check_hypers(self):
        super()._check_hypers()
        self.f_degree.check_dims(None)
        self.f_degree.check_hypers(self.name + "_")

    def th_loglike_fn(self):
        density = self.f_density
        degree = self.f_degree

        def fn(params, space, inputs, outputs):
            z = self._latent_z(params, inputs, outputs)
            chol = safe_cholesky(self._correlation(params, inputs))
            w = solve_lower_triangular(chol, z)
            n = inputs.shape[0]
            nu = degree(params)
            # the t-copula density on gaussian margins (z through ndtri), the
            # JAX package's approximation of the t-copula score
            joint = (gammaln((nu + n) / 2.0) - gammaln(nu / 2.0)
                     - torch.log(torch.diagonal(chol)).sum()
                     - 0.5 * (nu + n) * torch.log1p(torch.dot(w, w) / nu))
            indep = (n * (gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0))
                     - 0.5 * (nu + 1.0) * torch.log1p(z ** 2 / nu).sum())
            return _guarded(joint - indep + density.logp(params, inputs, outputs), z)

        return fn


class TransformedStudentTProcess(CopulaStudentTProcess):
    """The reference's name for the Student-t copula process."""
