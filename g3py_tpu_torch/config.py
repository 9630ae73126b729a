"""Numeric and runtime policy for g3py_tpu_torch.

The PyTorch counterpart of :mod:`g3py_tpu.config`: an explicit settings
object instead of ambient flags.  ``device`` names where model tensors live;
it defaults to ``"cuda"``: the entry points run on the card unless the
caller says ``settings.device = "cpu"``.  Nothing falls back — without a
card the first tensor op raises torch's own error.

Grams feed a Cholesky, so float32 matrix products must be full float32 —
the counterpart of the JAX package's ``matmul_precision='highest'``.
PyTorch's default already keeps cuBLAS matmuls out of TF32, but cuDNN is
TF32 by default; both are pinned off here so the policy is stated, not
inherited.
"""

import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Settings", "settings", "floatx", "set_floatx", "asarray_x",
           "as_tensor", "host_statistic", "device_statistics"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass
class Settings:
    """Numeric and runtime policy.

    Attributes:
      floatx: compute dtype of every model tensor ("float32" or "float64").
      strict_dtypes: if True, :func:`asarray_x` raises on a float64 input
        instead of casting it (the reference's ``warn_float64='raise'``).
      cholesky_max_tries: bound on the factorization attempts of
        :func:`g3py_tpu_torch.ops.linalg.safe_cholesky` (one clean attempt
        plus escalating-jitter retries).
      cholesky_jitter: relative base jitter, ``mean(diag) * cholesky_jitter``.
      logp_guard: value returned by a logp whose NaN/Inf guards trip.
      quadrature_degree: Gauss-Hermite degree of warped-process moments.
      mc_simulations: default Monte-Carlo draws of the transport and
        copula moments.
      device: torch device of model tensors ("cpu", "cuda", "cuda:1", ...).
      ssm_harmonics: cosine harmonics kept in the state-space expansion of
        the SIN (exp-sin^2 periodic) kernel (``ops/ssm.py`` PeriodicLeaf);
        the truncation tail is sum_{j>J} 2 e^{-r} I_j(r), keep J >= rate + 8.
      ssm_se_order: Taylor order of the SE kernel's state-space
        approximation (``ops/ssm.py`` SELeaf): kernel error relative to var
        4.3e-3 / 9.1e-4 / 2.1e-4 at order 6 / 8 / 10 in float32, and 10 is
        the float32 ceiling (its eigen-form constants grow ~13x per +2).
      ssm_laplace_iters: Newton iterations of the Laplace mode of the
        non-gaussian state-space family (``models/ngssm.py``), each one
        smoothing pass; log-concave likelihoods converge in ~5.
      ssm_chunk_threshold: above this many rows the state-space families
        take the chunked monoid scans (``chunked_kalman_nll`` for the
        loglike, ``chunked_smoother_diag`` for the statistics), whose
        activation memory is O(``ssm_chunk``) rows.
      ssm_chunk: rows of one block of those scans.
      ssm_mxu_state_dim: the JAX package's state dimension at which its
        tiny products leave a TPU's vector unit; accepted, changes nothing
        here (every product is a full-FP32 ``torch.matmul``).
      plot_big: whether the plot styles draw the thick lines of
        ``style_big`` (:mod:`g3py_tpu_torch.utils.plots`).
    """

    floatx: str = "float32"
    strict_dtypes: bool = False
    cholesky_max_tries: int = 21
    cholesky_jitter: float = 1e-6
    logp_guard: float = -1e30
    quadrature_degree: int = 10
    mc_simulations: int = 30
    device: str = "cuda"
    ssm_harmonics: int = 7
    ssm_se_order: int = 8
    ssm_laplace_iters: int = 15
    ssm_chunk_threshold: int = 1_048_576
    ssm_chunk: int = 262_144
    ssm_mxu_state_dim: int = 10_000
    plot_big: bool = False

    @property
    def dtype(self):
        return getattr(torch, self.floatx)


settings = Settings()


def floatx():
    """The active compute dtype (numpy dtype object)."""
    return np.dtype(settings.floatx)


def set_floatx(name: str):
    settings.floatx = name


def asarray_x(value):
    """Host array in the active float dtype (numeric input only); under
    ``settings.strict_dtypes`` a float64 input is an error."""
    arr = np.asarray(value)
    if settings.strict_dtypes and arr.dtype == np.float64:
        raise TypeError("float64 input under strict_dtypes (reference warn_float64='raise')")
    if np.issubdtype(arr.dtype, np.floating) or np.issubdtype(arr.dtype, np.integer):
        return arr.astype(settings.floatx)
    return arr


def as_tensor(value):
    """Tensor in the active dtype on ``settings.device``; no copy when the
    value already is one."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=settings.dtype, device=settings.device)
    return torch.as_tensor(asarray_x(value), device=settings.device)


# ---------------------------------------------------------------------------
# the host boundary of the statistics
# ---------------------------------------------------------------------------
def _to_host(value):
    """Tensors, and the tensors of a dict or tuple, as host numpy arrays of
    their dtype; anything else (floats, callables) as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return type(value)({k: _to_host(v) for k, v in value.items()})
    if isinstance(value, tuple):
        return tuple(_to_host(v) for v in value)
    return value


def host_statistic(fn):
    """A host-facing statistic (``predict``, ``mean``, ``quantiler``, a
    predictor's call, ...): its caller gets host numpy arrays (the tensors
    of a dict or tuple converted, in the dtype the statistic was computed
    in), which numpy reduces as it reduces the JAX package's arrays.  The
    port's own consumers call the body, ``fn.__wrapped__``
    (:class:`device_statistics`), and keep the device tensors."""

    @functools.wraps(fn)
    def method(*args, **kwargs):
        return _to_host(fn(*args, **kwargs))

    method.host_statistic = True
    return method


class device_statistics:
    """The tensor bodies of an object's host statistics, for the port's own
    consumers: ``device_statistics(proc).mean(params, space)`` is what
    ``proc.mean`` computes, before its host copy."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        method = getattr(self._obj, name)
        return functools.partial(method.__func__.__wrapped__, method.__self__)
