"""Mean (location) functions (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.means`), each ``(params, x) -> (N,)``, or ``(R, N)``
for a params dict of R rows (:class:`Zero` stays ``(N,)`` and
broadcasts)."""

import numpy as np
import torch

from . import Hypers, Flat, hval, is_param, slice_dims
from ..config import settings

__all__ = ["Mean", "Zero", "Bias"]


class Mean(Hypers):
    """Base mean; ``__call__(params, x)`` slices active dims then evals."""

    def eval(self, params, x):
        raise NotImplementedError

    def __call__(self, params, x):
        return self.eval(params, slice_dims(x, self.dims))


class Zero(Mean):
    """m(x) = 0."""

    def eval(self, params, x):
        return torch.zeros((x.shape[0],), dtype=settings.dtype, device=x.device)


class Bias(Mean):
    """Constant mean, default = mean(y)."""

    def __init__(self, x=None, name=None, bias=None):
        super().__init__(x, name)
        self.bias = bias

    def check_hypers(self, parent=""):
        self.bias = self._param(self.bias, parent + self.name + "_Bias", Flat())

    def default_hypers(self, x=None, y=None):
        if not is_param(self.bias):
            return {}
        return {self.bias: np.asarray(np.mean(y), dtype=settings.floatx)}

    def eval(self, params, x):
        return hval(self.bias, params)[..., None] * torch.ones(
            (x.shape[0],), dtype=settings.dtype, device=x.device)
