"""Transport processes — push-forwards of white noise through triangular
maps (the PyTorch counterpart of :mod:`g3py_tpu.models.transport`).

The process is a Transport map T(x, .); its observed density is

  logp = -n/2 log 2pi - 1/2 |T^{-1}(y)|^2 + log|det dT^{-1}(y)|

(a TKernel factors its gram through K2, builds it through K1), and its
moments are Monte-Carlo over ``T(randn)`` draws (``settings.mc_simulations``
by default).  The draws are numpy's (the same seed gives the JAX
package's normals); all S of them go through the transport as one (m, S)
matrix, so the joint (n + m) gram is factored once for the S columns where
the JAX package factors it once a column.  ``mean``, ``std``, ``variance``,
``median`` and ``quantiler`` each draw anew unless handed the draws
(``simulations``: an int or an (m, S) matrix); ``predict`` draws once for
all of them.
"""

import math

import numpy as np
import torch

from ..config import settings, as_tensor, host_statistic, device_statistics
from ..hypers.transports import ID
from ..ops.guards import to_num
from .stochastic import StochasticProcess, _statistic

__all__ = ["TransportProcess", "TransportGaussianProcess", "transport_gaussian_logp_t",
           "TransportGaussianDistribution"]

LOG2PI = math.log(2.0 * math.pi)


def transport_gaussian_logp_t(value, delta, logdet_dinv):
    """logp of the transport push-forward, ``delta = T^{-1}(y)``."""
    r = -0.5 * value.shape[0] * LOG2PI - 0.5 * torch.dot(delta, delta) + logdet_dinv
    bad = ~torch.isfinite(delta).all() | ~torch.isfinite(logdet_dinv)
    guard = settings.logp_guard
    return torch.where(bad, torch.full_like(r, guard), to_num(r, nan=guard, neginf=guard))


class TransportGaussianDistribution:
    """Namespace kept for the reference's API."""

    logp_t = staticmethod(transport_gaussian_logp_t)


class TransportProcess(StochasticProcess):
    """A process defined by a Transport map (default: the identity)."""

    _batched_rows = False

    def __init__(self, space=None, transport=None, *args, **kwargs):
        self.f_transport = transport if transport is not None else ID()
        super().__init__(space, *args, **kwargs)

    def _components(self):
        return [self.f_transport]

    def _check_hypers(self):
        self.f_transport.check_dims(self.inputs)
        self.f_transport.check_hypers(self.name + "_")

    def default_hypers(self):
        return self.f_transport.default_hypers_dims(self.inputs, self.outputs)

    # -- transport selectors ------------------------------------------------------
    def th_transport(self, prior=False, noise=False):
        t = self.f_transport
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return t(params, space, vector, noise=noise)
        else:
            def fn(params, space, inputs, outputs, vector):
                return t.posterior(params, space, vector, inputs, outputs, noise_pred=noise,
                                   noise_obs=True)
        return fn

    def th_transport_diag(self, prior=False, noise=False):
        t = self.f_transport
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return t.diag(params, space, vector, noise=noise)
        else:
            def fn(params, space, inputs, outputs, vector):
                return t.posterior(params, space, vector, inputs, outputs, noise_pred=noise,
                                   noise_obs=True, diag=True)
        return fn

    def th_transport_inv(self, prior=False, noise=False):
        t = self.f_transport

        def fn(params, space, inputs, outputs, vector):
            return t.inv(params, space, vector, noise=noise)
        return fn

    transport = _statistic("th_transport", "Push ``vector`` through the (posterior) map.")
    transport_diag = _statistic("th_transport_diag",
                                "Push ``vector`` through the map's marginal scales.")
    transport_inv = _statistic("th_transport_inv", "Pull ``vector`` back to white noise.")

    # the marginal and bivariate density plots draw nothing for a transport
    # process, as in the JAX package
    def plot_model(self, *args, **kwargs):
        pass

    def plot_distribution(self, *args, **kwargs):
        pass

    def plot_distribution2D(self, *args, **kwargs):
        pass


class TransportGaussianProcess(TransportProcess):
    """TGP: the observed density through the transport's pullback;
    Monte-Carlo moments."""

    _mc_moments = True

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "TGP")
        super().__init__(*args, **kwargs)

    def th_define_process(self):
        self.distribution = TransportGaussianDistribution

    def th_loglike_fn(self):
        t = self.f_transport

        def fn(params, space, inputs, outputs):
            delta = t.inv(params, inputs, outputs, noise=True)
            logdet = t.logdet_dinv(params, inputs, outputs)
            return transport_gaussian_logp_t(outputs, delta, logdet)

        return fn

    # -- Monte-Carlo moments --------------------------------------------------------
    def _mc_samples(self, params, space, inputs, outputs, prior, noise, simulations,
                    rng=None):
        if simulations is None:
            simulations = settings.mc_simulations
        if isinstance(simulations, int):
            return device_statistics(self).sampler(
                params=params, space=space, inputs=inputs, outputs=outputs,
                samples=simulations, prior=prior, noise=noise, rng=rng)
        return as_tensor(simulations)

    @host_statistic
    def mean(self, params=None, space=None, inputs=None, outputs=None, prior=False,
             noise=False, simulations=None, rng=None, **kwargs):
        """Monte-Carlo mean over ``simulations`` draws (an int, or the draws)."""
        return self._mc_samples(params, space, inputs, outputs, prior, noise, simulations,
                                rng).mean(dim=1)

    @host_statistic
    def std(self, params=None, space=None, inputs=None, outputs=None, prior=False,
            noise=False, simulations=None, rng=None, **kwargs):
        return self._mc_samples(params, space, inputs, outputs, prior, noise, simulations,
                                rng).std(dim=1, unbiased=False)

    @host_statistic
    def variance(self, params=None, space=None, inputs=None, outputs=None, prior=False,
                 noise=False, simulations=None, rng=None, **kwargs):
        return self._mc_samples(params, space, inputs, outputs, prior, noise, simulations,
                                rng).var(dim=1, unbiased=False)

    @host_statistic
    def median(self, params=None, space=None, inputs=None, outputs=None, prior=False,
               noise=False, simulations=None, rng=None, **kwargs):
        return torch.nanquantile(self._mc_samples(params, space, inputs, outputs, prior,
                                                  noise, simulations, rng), 0.5, dim=1)

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None, rng=None):
        """The q-quantile of the draws (linear interpolation, as
        ``np.nanpercentile``)."""
        return torch.nanquantile(self._mc_samples(params, space, inputs, outputs, prior,
                                                  noise, simulations, rng), q, dim=1)

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """``samples`` draws at the space, (m, samples): numpy standard
        normals from ``rng`` (a fresh Generator when None) pushed through
        the (posterior) transport, all columns at once."""
        if space is None:
            space = self.space
        if rng is None:
            rng = np.random.default_rng()
        rand = rng.standard_normal((len(space), samples)).astype(settings.floatx)
        p = self._tensor_params(self.params if params is None else params)
        if inputs is None and not self.is_observed:
            prior = True
        space, inputs, outputs = self._resolve_data(
            None if space is self._space else space, inputs, outputs)
        return self.th_transport(prior=prior, noise=noise)(p, space, inputs, outputs,
                                                           as_tensor(rand))
