"""Serving fast path: factor once, answer query batches with products.

The PyTorch counterpart of :class:`g3py_tpu.models.predictor.Predictor`
and :class:`~g3py_tpu.models.predictor.AveragedPredictor`.  The observed
gram is factored ONCE into ``(L^{-1}, alpha, z)`` device tensors
(``EllipticalProcess.posterior_state``); each query batch then costs one
cross gram ``K(x*, X)`` and one query gram (both through the fused
stationary-gram kernel on the card), one product with ``L^{-1}`` and
elementwise work:

  mean(s)  = T(m(s) + K_sX alpha)                    (GH quadrature for WGP)
  var(s)   = k_ss - colsum((L^{-1} K_Xs)^2)           (+ noise for bands)

and a Student-t process scales the variance by (nu + z'z - 2)/(nu + n - 2)
from the state's whitened residual z and takes Student-t quantiles at
nu + n degrees of freedom (per row for an averaged predictor).

Every requested statistic of a batch shares that one cross gram.  The
averaged predictor holds one state per datatrace row, stacked, factored by
one batched K2 call; its query batch is one batched K1 cross gram, one
batched query gram and batched products for all rows, averaged over the
rows.  The JAX package bakes the state into per-statistic jitted closures
to dodge a TPU runtime's per-argument dispatch cost; eager PyTorch has no
such cost, so these predictors are plain objects holding tensors.
"""

import numpy as np
import torch

from ..config import settings
from ..utils import DictObj
from ..bayesian.models import _row_scores

__all__ = ["Predictor", "AveragedPredictor", "statistics"]


def statistics(proc, p, space, inputs, outputs, mean=True, std=True, var=False, cov=False,
               median=False, quantiles=False, quantiles_noise=False, noise=False,
               prior=False, batch=False):
    """Statistics of one query batch from a params dict ``p`` that carries
    a posterior state (same keys as ``process.predict``): ``mean``, ``std``,
    ``variance``, ``covariance`` (m, m), ``median``,
    ``quantile_up``/``quantile_down`` (2.5% and 97.5%) and, with
    ``quantiles_noise``, the observation-noise bands ``noise_std``,
    ``noise_up`` and ``noise_down``; with ``prior`` the prior's.  A dict of
    R rows gives (R, m).  The latent quantile coefficients and the moments
    are the process's own (a Student-t process scales the variance by its
    posterior factor and takes Student-t quantiles); ``batch`` takes the
    coefficients of ``batch_predict``."""
    up, down = proc._quantile_pair(p, inputs, prior=prior, batch=batch)
    values = DictObj()

    def bands(var):  # T(loc + z_q sd) at q = 97.5% and 2.5%
        sd = torch.sqrt(var)
        return proc.f_mapping(p, loc + up * sd), proc.f_mapping(p, loc + down * sd)

    with torch.no_grad():
        loc, latent, noise_var = proc._latent_moments(p, space, inputs, outputs, prior=prior)
        moments = proc._moments_fn(p, inputs, outputs, prior=prior)
        lvar = latent + noise_var if noise else latent
        if mean or std or var:
            m, v = moments(loc, lvar)
            if mean:
                values["mean"] = m
            if var:
                values["variance"] = v
            if std:
                values["std"] = torch.sqrt(v)
        if cov:
            cov_fn = proc.th_covariance(prior=prior, noise=noise)
            if cov_fn is None:
                raise ValueError(f"{type(proc).__name__} has no analytic posterior covariance")
            values["covariance"] = cov_fn(p, space, inputs, outputs, None)
        if median:
            values["median"] = proc.f_mapping(p, loc)
        if quantiles:
            values["quantile_up"], values["quantile_down"] = bands(lvar)
        if quantiles_noise:
            nvar = latent + noise_var
            values["noise_std"] = torch.sqrt(moments(loc, nvar)[1])
            values["noise_up"], values["noise_down"] = bands(nvar)
    return values


class _Bound:
    """A process and its observed data at factorization time; rejects use
    after the data changed."""

    def _bind(self, process):
        self.process = process
        self._inputs_ref = process._inputs
        self._outputs_ref = process._outputs
        self.inputs = process._device_data("inputs")
        self.outputs = process._device_data("outputs")

    def _check(self):
        if (self.process._inputs is not self._inputs_ref
                or self.process._outputs is not self._outputs_ref):
            raise ValueError(
                f"the process's observed data changed after this {type(self).__name__}'s "
                "factorization — rebuild it")
        return self

    def _space(self, space):
        """Query points as a device matrix; the process's space when None."""
        return (self.process._device_data("space") if space is None
                else self.process._as_matrix(space))


class Predictor(_Bound):
    """Bound (process, params, factorized posterior state) for streaming
    prediction.

    >>> pr = gp.predictor(params)          # one O(n^3) factorization
    >>> out = pr(x_query, quantiles=True)  # dict of tensors for the batch

    The state snapshots the process's observed inputs and outputs;
    changing them later (``observed``) invalidates the predictor, which then
    raises — rebuild it with ``process.predictor(params)``."""

    def __init__(self, process, params=None):
        if params is None:
            params = process.params
        self._bind(process)
        self.params = process._tensor_params(process.filter_params(params))
        self.state = process.posterior_state(self.params)
        self._merged = {**self.params, **self.state}

    def predict(self, space=None, mean=True, std=True, var=False, cov=False, median=False,
                quantiles=False, quantiles_noise=False, samples=0, distribution=False,
                prior=False, noise=False, simulations=None, fused=True):
        """Statistics of one query batch (see :func:`statistics`; the
        process's space when ``space`` is None), plus ``samples`` posterior
        draws (m, samples) and, with ``distribution``, ``logpredictive``: a
        function of a vector of values at the space.  ``simulations`` and
        ``fused`` change nothing: the gaussian statistics are analytic and
        always share one cross gram."""
        self._check()
        space = self._space(space)
        values = statistics(self.process, self._merged, space, self.inputs, self.outputs,
                            mean=mean, std=std, var=var, cov=cov, median=median,
                            quantiles=quantiles, quantiles_noise=quantiles_noise,
                            noise=noise, prior=prior)
        if samples > 0:
            values["samples"] = self.process.sampler(self._merged, space, samples=samples,
                                                     prior=prior, noise=noise)
        if distribution:
            values["logpredictive"] = lambda v: self.logpredictive(v, space, prior=prior)
        return values

    __call__ = predict

    def median(self, space=None, prior=False):
        """T(location) at the query points."""
        return self.predict(space, mean=False, std=False, median=True, prior=prior)["median"]

    def logpredictive(self, vector, space=None, prior=False):
        """Independent-marginal log predictive density of ``vector`` at the
        query points (noise included), from the factored state."""
        self._check()
        with torch.no_grad():
            return self.process.logpredictive(self._merged, self._space(space), vector=vector,
                                              prior=prior, noise=True)


class AveragedPredictor(_Bound):
    """Streaming Bayesian model average: one factorization PER DATATRACE
    ROW — all rows in one batched K2 call — then every query batch is
    row-batched products and an average.

    >>> ap = gp.averaged_predictor(dt)       # R factorizations, one batch
    >>> out = ap(x_query, quantiles=True)    # averaged statistics (float64)

    Memory: the stacked state is R x n_obs^2 values (capped by
    ``max_rows``; rows are subsampled evenly beyond it, matching the
    average's Monte-Carlo nature)."""

    def __init__(self, process, datatrace, max_rows=64):
        rows = (process._datatrace_rows(datatrace) if hasattr(datatrace, "columns")
                else np.asarray(datatrace, settings.floatx))
        if rows.ndim == 1:
            rows = rows[None, :]
        if len(rows) > max_rows:
            rows = rows[np.linspace(0, len(rows) - 1, max_rows).astype(int)]
        self._bind(process)
        self.rows = np.asarray(rows, settings.floatx)
        self.params, self.state_rows = process.posterior_state_rows(
            self.rows, self.inputs, self.outputs)
        self._merged = {**self.params, **self.state_rows}

    def batch(self, space=None, **flags):
        """Per-row statistics (leading row axis), like
        ``process.batch_predict``, with the factorizations reused."""
        self._check()
        return statistics(self.process, self._merged, self._space(space), self.inputs,
                          self.outputs, batch=True, **flags)

    def predict(self, space=None, scores=False, **flags):
        """Row-averaged statistics (the ``average()`` keys), in float64;
        ``scores=True`` adds ``_l1``/``_l2`` of the rows' means against the
        process's ``hidden`` when the query space is ``hidden``'s."""
        batch = self.batch(space=space, **flags)
        out = DictObj({k: v.to(torch.float64).mean(dim=0) for k, v in batch.items()})
        if scores and "mean" in batch:
            out.update(_row_scores(batch["mean"], self.process.hidden))
        return out

    __call__ = predict
