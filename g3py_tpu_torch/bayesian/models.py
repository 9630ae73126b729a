"""Datatrace-wide (batched) model evaluation (the PyTorch counterpart of the
batched half of :class:`g3py_tpu.bayesian.models.PlotModel`).

The reference evaluated a datatrace by looping ``predict`` once per row.
The JAX package ``vmap``-s the row axis; here the rows are an explicit
leading axis: :meth:`BatchedModel.batch_predict` turns an (R, ndim) matrix
of unconstrained rows into one params dict of rows, factors every row's
posterior in ONE batched call, and evaluates every statistic for all rows
at once.  :meth:`BatchedModel.average` is its mean over the rows.
"""

import numpy as np
import torch

from ..config import settings
from ..utils import DictObj

__all__ = ["BatchedModel"]


class BatchedModel:
    """Mixin of :class:`~g3py_tpu_torch.models.stochastic.StochasticProcess`:
    needs ``active`` and the ``_batch_statistics`` hook of the process
    family."""

    def _datatrace_rows(self, datatrace):
        return np.asarray(datatrace[self.active.param_names()], dtype=settings.floatx)

    def _batch_statistics(self, rows, space, inputs, outputs, **flags):
        raise NotImplementedError(f"{type(self).__name__} has no batched predictive")

    def batch_predict(self, rows, space=None, inputs=None, outputs=None, mean=True,
                      std=True, var=False, quantiles=False, quantiles_noise=False,
                      prior=False, noise=False, **extra):
        """Requested statistics for an (R, ndim) matrix of unconstrained
        parameter rows, each a tensor with a leading row axis (the keys of
        ``predict``)."""
        unsupported = sorted(k for k, v in extra.items() if v)
        if unsupported:
            raise NotImplementedError(
                f"batch_predict does not support {unsupported} yet "
                "(ROADMAP Queue 1 item 7)")
        if prior or (inputs is None and not self.is_observed):
            raise NotImplementedError("batch_predict of the prior is not ported yet "
                                      "(ROADMAP Queue 1 item 7)")
        rows = np.asarray(rows, dtype=settings.floatx)
        if rows.ndim == 1:
            rows = rows[None, :]
        return self._batch_statistics(rows, space, inputs, outputs, mean=mean, std=std,
                                      var=var, quantiles=quantiles,
                                      quantiles_noise=quantiles_noise, noise=noise)

    def average(self, datatrace, *args, **kwargs):
        """Average predictions over the datatrace's rows (the reference's
        Bayesian model average), every row factored in one batched call;
        float64 tensors on ``settings.device``."""
        batch = self.batch_predict(self._datatrace_rows(datatrace), *args, **kwargs)
        return DictObj({k: v.to(torch.float64).mean(dim=0) for k, v in batch.items()})
