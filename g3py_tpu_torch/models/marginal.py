"""MarginalProcess — processes of independent marginal densities (the
PyTorch counterpart of :mod:`g3py_tpu.models.marginal`).

A :class:`Density` holds Mean-valued parameters (``Uniform(lower, upper)``,
``Normal(mu, sigma)``, ``StudentT(mu, sigma, nu)``).  Its ``logp`` and
``cdf`` run on ``settings.device`` (``cdf`` is what the copula family
reads); its ``ppf`` and the process's ``quantiler`` and ``sampler`` run
on the host through ``scipy.stats``, as in the JAX package (the sampler
on numpy's global generator, as the JAX package draws).  The family
launches no kernel: no gram, no factorization.
"""

import math

import numpy as np
import torch
from scipy import stats

from ..config import settings, as_tensor, host_statistic
from ..utils import DictObj
from ..ops.special import gammaln, norm_cdf, betainc
from .stochastic import StochasticProcess, _statistic

__all__ = ["Density", "SymmetricDensity", "Uniform", "Normal", "StudentT",
           "MarginalProcess"]

LOG2PI = math.log(2.0 * math.pi)


def _guard(lp, ok):
    """``lp`` where ``ok``, else ``settings.logp_guard``."""
    return torch.where(ok, lp, torch.full_like(lp, settings.logp_guard))


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Density:
    """Family of independent marginals with Mean-valued parameters."""

    def __init__(self, **kwargs):
        self.locations = DictObj(kwargs)

    @property
    def name(self):
        return type(self).__name__

    def check_dims(self, *args, **kwargs):
        for loc in self.locations.values():
            loc.check_dims(*args, **kwargs)

    def check_hypers(self, *args, **kwargs):
        for loc in self.locations.values():
            loc.check_hypers(*args, **kwargs)

    @property
    def hypers(self):
        out = []
        for loc in self.locations.values():
            out += loc.hypers
        return out

    @property
    def potential(self):
        return None

    def has_potential(self):
        """False: a density registers no potential of its own (its
        locations' potentials are not registered, as in the JAX package)."""
        return self.potential is not None

    def potential_logp(self, params):
        parts = [p for p in (loc.potential_logp(params) for loc in self.locations.values())
                 if p is not None]
        return sum(parts[1:], parts[0]) if parts else None

    def default_hypers_dims(self, *args, **kwargs):
        out = DictObj()
        for loc in self.locations.values():
            out.update(loc.default_hypers_dims(*args, **kwargs))
        return out

    # quantity hooks
    def th_median(self, params, space):
        raise NotImplementedError

    def th_mean(self, params, space):
        raise NotImplementedError

    def th_mode(self, params, space):
        raise NotImplementedError

    def th_variance(self, params, space):
        return self.th_std(params, space) ** 2

    def th_std(self, params, space):
        return torch.sqrt(self.th_variance(params, space))

    def logp(self, params, inputs, outputs):
        """Observed iid loglikelihood."""
        raise NotImplementedError

    def cdf(self, params, inputs, outputs):
        """Marginal CDF F(y_i | x_i), on the device."""
        raise NotImplementedError

    def ppf(self, params, inputs, q):
        """Marginal quantile function (host, scipy)."""
        raise NotImplementedError


class SymmetricDensity(Density):
    def th_median(self, params, space):
        return self.th_mean(params, space)

    def th_mode(self, params, space):
        return self.th_mean(params, space)


class Uniform(SymmetricDensity):
    """Uniform(lower(x), upper(x))."""

    def __init__(self, lower, upper):
        self.locations = DictObj(lower=lower, upper=upper)

    def th_mean(self, params, space):
        return 0.5 * (self.locations.lower(params, space) + self.locations.upper(params, space))

    def th_variance(self, params, space):
        return (1.0 / 12.0) * (self.locations.upper(params, space)
                               - self.locations.lower(params, space)) ** 2

    def th_lower(self, params, space):
        return self.locations.lower(params, space)

    def th_upper(self, params, space):
        return self.locations.upper(params, space)

    def logp(self, params, inputs, outputs):
        lower = self.th_lower(params, inputs)
        upper = self.th_upper(params, inputs)
        width = upper - lower
        inside = ((outputs >= lower) & (outputs <= upper) & (width > 0)).all()
        return _guard(-torch.log(torch.clamp(width, min=1e-38)).sum(), inside)

    def cdf(self, params, inputs, outputs):
        lower = self.th_lower(params, inputs)
        upper = self.th_upper(params, inputs)
        return torch.clamp((outputs - lower) / (upper - lower), 0.0, 1.0)

    def ppf(self, params, inputs, q):
        lower = _host(self.th_lower(params, inputs))
        upper = _host(self.th_upper(params, inputs))
        return lower + q * (upper - lower)


class Normal(SymmetricDensity):
    """Normal(mu(x), sigma(x))."""

    def __init__(self, mu, sigma):
        self.locations = DictObj(mu=mu, sigma=sigma)

    def th_mean(self, params, space):
        return self.locations.mu(params, space)

    def th_std(self, params, space):
        return torch.abs(self.locations.sigma(params, space))

    def logp(self, params, inputs, outputs):
        mu = self.th_mean(params, inputs)
        sd = self.th_std(params, inputs)
        z = (outputs - mu) / sd
        lp = (-0.5 * z ** 2 - torch.log(sd) - 0.5 * LOG2PI).sum()
        return _guard(lp, torch.isfinite(lp))

    def cdf(self, params, inputs, outputs):
        return norm_cdf(outputs, self.th_mean(params, inputs), self.th_std(params, inputs))

    def ppf(self, params, inputs, q):
        return stats.norm.ppf(q, loc=_host(self.th_mean(params, inputs)),
                              scale=_host(self.th_std(params, inputs)))


class StudentT(Normal):
    """StudentT(mu(x), sigma(x), nu(x)); its CDF goes through
    :func:`~g3py_tpu_torch.ops.special.betainc` (no gradient in nu)."""

    def __init__(self, mu, sigma, nu):
        self.locations = DictObj(mu=mu, sigma=sigma, nu=nu)

    def th_freedom(self, params, space):
        return self.locations.nu(params, space)

    def logp(self, params, inputs, outputs):
        mu = self.th_mean(params, inputs)
        sd = self.th_std(params, inputs)
        nu = self.th_freedom(params, inputs)
        z = (outputs - mu) / sd
        lp = (gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0) - 0.5 * torch.log(nu * math.pi)
              - torch.log(sd) - (nu + 1.0) / 2.0 * torch.log1p(z ** 2 / nu)).sum()
        return _guard(lp, torch.isfinite(lp))

    def cdf(self, params, inputs, outputs):
        mu = self.th_mean(params, inputs)
        sd = self.th_std(params, inputs)
        nu = self.th_freedom(params, inputs)
        z = (outputs - mu) / sd
        ib = betainc(nu / 2.0, torch.full_like(nu, 0.5), nu / (nu + z ** 2))
        return torch.where(z >= 0, 1.0 - 0.5 * ib, 0.5 * ib)

    def ppf(self, params, inputs, q):
        return stats.t.ppf(q, _host(self.th_freedom(params, inputs)),
                           loc=_host(self.th_mean(params, inputs)),
                           scale=_host(self.th_std(params, inputs)))


class MarginalProcess(StochasticProcess):
    """Process of independent marginals."""

    _batched_rows = False

    def __init__(self, space=None, density=None, *args, **kwargs):
        self.f_density = density
        kwargs.setdefault("name", "MP")
        super().__init__(space, *args, **kwargs)

    def _components(self):
        return [self.f_density]

    def _check_hypers(self):
        self.f_density.check_dims(self.inputs)
        self.f_density.check_hypers(self.name + "_")

    def default_hypers(self):
        return self.f_density.default_hypers_dims(self.inputs, self.outputs)

    def th_loglike_fn(self):
        density = self.f_density

        def fn(params, space, inputs, outputs):
            return density.logp(params, inputs, outputs)

        return fn

    # -- delegated quantities ---------------------------------------------------
    def _delegate(self, name):
        hook = getattr(self.f_density, name, None)
        if hook is None:
            return None
        return lambda params, space, inputs, outputs, vector: hook(params, space)

    def th_lower(self, prior=False, noise=False):
        return self._delegate("th_lower")

    def th_upper(self, prior=False, noise=False):
        return self._delegate("th_upper")

    def th_freedom(self, prior=False, noise=False):
        return self._delegate("th_freedom")

    def th_median(self, prior=False, noise=False, simulations=None):
        return self._delegate("th_median")

    def th_mean(self, prior=False, noise=False, simulations=None):
        return self._delegate("th_mean")

    def th_variance(self, prior=False, noise=False, simulations=None):
        return self._delegate("th_variance")

    def th_covariance(self, prior=False, noise=False):
        return lambda params, space, inputs, outputs, vector: torch.diag(
            self.f_density.th_variance(params, space))

    def th_logpredictive(self, prior=False, noise=False):
        density = self.f_density

        def fn(params, space, inputs, outputs, vector):
            return density.logp(params, space, vector)

        return fn

    lower = _statistic("th_lower", "Lower bound (Uniform).")
    upper = _statistic("th_upper", "Upper bound (Uniform).")
    freedom = _statistic("th_freedom", "Degrees of freedom (StudentT).")

    # -- scipy on the host ----------------------------------------------------------
    def _host_stats(self, names, params, space, inputs, outputs, prior, noise):
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior, noise=noise)
        return [_host(getattr(self, name)(params, **kw)) for name in names]

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """The marginal quantile at ``q`` (``scipy.stats`` ppf)."""
        args = (params, space, inputs, outputs, prior, noise)
        if isinstance(self.f_density, StudentT):
            nu, mean, std = self._host_stats(("freedom", "mean", "std"), *args)
            out = stats.t.ppf(q, nu, loc=mean, scale=std)
        elif isinstance(self.f_density, Uniform):
            lower, upper = self._host_stats(("lower", "upper"), *args)
            out = stats.uniform.ppf(q, loc=lower, scale=upper - lower)
        else:
            mean, std = self._host_stats(("mean", "std"), *args)
            out = stats.norm.ppf(q, loc=mean, scale=std)
        return as_tensor(out)

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """``samples`` draws at the space, (m, samples), from ``scipy.stats``
        on numpy's global generator (``rng`` is accepted and unused, as in
        the JAX package)."""
        if space is None:
            space = self.space
        size = (samples, len(space))
        args = (params, space, inputs, outputs, prior, noise)
        if isinstance(self.f_density, StudentT):
            nu, mean, std = self._host_stats(("freedom", "mean", "std"), *args)
            rand = stats.t.rvs(nu, loc=mean, scale=std, size=size)
        elif isinstance(self.f_density, Uniform):
            lower, upper = self._host_stats(("lower", "upper"), *args)
            rand = stats.uniform.rvs(loc=lower, scale=upper - lower, size=size)
        else:
            mean, std = self._host_stats(("mean", "std"), *args)
            rand = stats.norm.rvs(loc=mean, scale=std, size=size)
        return as_tensor(rand.T.astype(settings.floatx))
