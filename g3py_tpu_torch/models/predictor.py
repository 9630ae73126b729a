"""Serving fast path: factor once, answer query batches with products.

The PyTorch counterpart of :class:`g3py_tpu.models.predictor.Predictor`.
The observed gram is factored ONCE into ``(L^{-1}, alpha, z)`` device
tensors (``EllipticalProcess.posterior_state``); each query batch then costs
one cross gram ``K(x*, X)`` and one query gram (both through the fused
stationary-gram kernel on the card), one product with ``L^{-1}`` and
elementwise work:

  mean(s)  = T(m(s) + K_sX alpha)                    (GH quadrature for WGP)
  var(s)   = k_ss - colsum((L^{-1} K_Xs)^2)           (+ noise for bands)

Every requested statistic of a batch shares that one cross gram.  The JAX
package bakes the state into per-statistic jitted closures to dodge a TPU
runtime's per-argument dispatch cost; eager PyTorch has no such cost, so
this Predictor is a plain object holding tensors.
"""

import torch

from ..utils import DictObj

__all__ = ["Predictor"]


class Predictor:
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
        self.process = process
        self.params = process._tensor_params(process.filter_params(params))
        self._inputs_ref = process._inputs
        self._outputs_ref = process._outputs
        self.inputs = process._device_data("inputs")
        self.outputs = process._device_data("outputs")
        self.state = process.posterior_state(self.params)
        self._merged = {**self.params, **self.state}

    def _check(self):
        if (self.process._inputs is not self._inputs_ref
                or self.process._outputs is not self._outputs_ref):
            raise ValueError(
                "the process's observed data changed after this Predictor's "
                "factorization — rebuild it with process.predictor(params)")

    def predict(self, space, mean=True, std=True, var=False, quantiles=False,
                quantiles_noise=False, noise=False):
        """Statistics of one query batch (same keys as ``process.predict``):
        ``mean``, ``std``, ``variance``, ``quantile_up``/``quantile_down``
        (2.5% and 97.5%) and, with ``quantiles_noise``, the observation-noise
        bands ``noise_std``, ``noise_up`` and ``noise_down``."""
        self._check()
        proc = self.process
        p = self._merged
        space = proc._as_matrix(space)
        up, down = proc._quantile_p(0.975), proc._quantile_p(0.025)
        values = DictObj()

        def bands(var):  # T(loc + z_q sd) at q = 97.5% and 2.5%
            sd = torch.sqrt(var)
            return proc.f_mapping(p, loc + up * sd), proc.f_mapping(p, loc + down * sd)

        with torch.no_grad():
            loc, latent, noise_var = proc._latent_moments(p, space, self.inputs,
                                                          self.outputs)
            lvar = latent + noise_var if noise else latent
            if mean or std or var:
                m, v = proc._warped_moments(p, loc, lvar)
                if mean:
                    values["mean"] = m
                if var:
                    values["variance"] = v
                if std:
                    values["std"] = torch.sqrt(v)
            if quantiles:
                values["quantile_up"], values["quantile_down"] = bands(lvar)
            if quantiles_noise:
                nvar = latent + noise_var
                values["noise_std"] = torch.sqrt(proc._warped_moments(p, loc, nvar)[1])
                values["noise_up"], values["noise_down"] = bands(nvar)
        return values

    __call__ = predict
