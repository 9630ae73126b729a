"""Fused stationary gram: a hand-written CUDA kernel and its plain version.

``var * k(ARD_L2(x1, x2))`` for the SE, MAT32, MAT52 and RQ families — the
gram behind every observed, cross and query covariance of exact GP/WGP
regression.  A batch of hyperparameter rows (``rate`` of shape (R, d),
``var`` and the RQ ``alpha`` of shape (R,)) gives R grams (R, m, n) from one
launch: the sampler's walkers and the datatrace rows of the averaged
predictor go through it this way.  The port of the TPU kernel
``g3py_tpu/ops/pallas_gram.py::_stationary_kernel``; the CUDA source is
``csrc/stationary_gram.cu`` and says what bounds it on the card.

* :func:`stationary_gram` is the entry point.  On a CPU tensor it computes
  the plain PyTorch version :func:`_plain_form`; on a CUDA tensor it
  launches the kernel or raises — a missing ``nvcc``, a failed build or a
  failed launch is an error, never a fallback.
* The kernel library is built by :mod:`._build` (``nvcc`` at first use,
  ``ctypes``), together with the port's other kernels.
* ``stationary_gram.launches`` counts kernel launches (and nothing else),
  so a run can show that its main path went through the kernel;
  ``stationary_gram.by_shape`` counts them by ``(kind, R, m, n, d)``.
* The gradient is a ``torch.autograd.Function`` whose backward
  differentiates the plain form, as the TPU package's ``_gram_hybrid``
  replays the vjp of its XLA form.
* The launch is registered as the operator ``g3py_tpu_torch::stationary_gram``
  (``torch.library``: the launch on CUDA tensors, the plain form on CPU
  tensors, a shape function for tracing), and the autograd Function
  calls it, so that ``torch.export`` records K1 as one node: an exported
  predictor (:mod:`g3py_tpu_torch.serving`) calls the same kernel when it
  is loaded on the card.
"""

import ctypes

import torch

from . import _build
from .gram import weighted_sqdist

__all__ = ["stationary_gram", "KINDS"]

#: family name -> the kernel's template index (csrc/stationary_gram.cu Kind)
KINDS = {"se": 0, "mat32": 1, "mat52": 2, "rq": 3}
# one 64-row tile per grid row, and a grid has at most 65535 rows; one
# batch row per grid layer, at most 65535 of them
_MAX_ROWS = 64 * 65535
_MAX_BATCH = 65535

# elementwise k(d_metric) on the ARD_L2 distance d_metric = 0.5 |s1 - s2|^2;
# the sqrt argument is clamped away from 0 for a finite lengthscale gradient
# at the gram diagonal (see hypers.kernels.MAT32)
_KFORMS = {
    "se": lambda dm, extra: torch.exp(-dm),
    "mat32": lambda dm, extra: (
        (1.0 + torch.sqrt(torch.clamp(3.0 * dm, min=1e-36)))
        * torch.exp(-torch.sqrt(torch.clamp(3.0 * dm, min=1e-36)))),
    "mat52": lambda dm, extra: (
        (1.0 + torch.sqrt(torch.clamp(5.0 * dm, min=1e-36)) + 5.0 * dm / 3.0)
        * torch.exp(-torch.sqrt(torch.clamp(5.0 * dm, min=1e-36)))),
    "rq": lambda dm, extra: torch.pow(1.0 + dm / extra, -extra),
}

def _entry(dtype):
    """The C entry point for ``dtype``, its ctypes signature set."""
    fn = getattr(_build.library("stationary_gram"),
                 "stationary_gram_f32" if dtype == torch.float32 else "stationary_gram_f64")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_rows(t, ref, rows, what):
    """``t`` as a contiguous (rows,) tensor of ``ref``'s dtype and device: one
    value a row (a one-element tensor for a single gram)."""
    if not isinstance(t, torch.Tensor) or t.numel() != rows:
        raise ValueError(f"stationary_gram: {what} must hold one value a row ({rows})")
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"stationary_gram: {what} must be {ref.dtype} on {ref.device}, "
                         f"got {t.dtype} on {t.device}")
    return t.reshape(rows).contiguous()


def _launch(kind, s1, s2, var, extra):
    """Run the kernel on rate-scaled, centred (R, m, d) and (R, n, d) CUDA
    tensors with (R,) ``var`` and ``extra``; returns the (R, m, n) grams."""
    if kind not in KINDS:
        raise ValueError(f"stationary_gram: unknown kind {kind!r}")
    if s1.device.type != "cuda" or s2.device != s1.device:
        raise ValueError("stationary_gram: the kernel takes CUDA tensors on one device")
    if s1.dtype not in (torch.float32, torch.float64) or s2.dtype != s1.dtype:
        raise ValueError(f"stationary_gram: float32 or float64 inputs of one dtype, "
                         f"got {s1.dtype} and {s2.dtype}")
    if (s1.ndim != 3 or s2.ndim != 3 or s1.shape[0] != s2.shape[0]
            or s1.shape[2] != s2.shape[2]):
        raise ValueError(f"stationary_gram: shapes {tuple(s1.shape)} and "
                         f"{tuple(s2.shape)} are not (R, m, d) and (R, n, d)")
    if not (s1.is_contiguous() and s2.is_contiguous()):
        raise ValueError("stationary_gram: inputs must be contiguous")
    rows, m, d = s1.shape
    n = s2.shape[1]
    if max(m, n, d) >= 2**31 or m > _MAX_ROWS or not 1 <= rows <= _MAX_BATCH:
        raise ValueError(f"stationary_gram: (R, m, n, d) = ({rows}, {m}, {n}, {d}) exceeds "
                         f"the launch grid (m <= {_MAX_ROWS}, n and d < 2**31, "
                         f"1 <= R <= {_MAX_BATCH})")
    var = _check_rows(var, s1, rows, "var")
    if kind == "rq":
        extra = _check_rows(extra, s1, rows, "alpha")
    out = torch.empty((rows, m, n), dtype=s1.dtype, device=s1.device)
    if m == 0 or n == 0:
        return out
    fn = _entry(s1.dtype)
    with torch.cuda.device(s1.device):
        stream = torch.cuda.current_stream(s1.device).cuda_stream
        rc = fn(s1.data_ptr(), s2.data_ptr(), var.data_ptr(),
                extra.data_ptr() if kind == "rq" else None, out.data_ptr(),
                m, n, d, rows, KINDS[kind], stream)
    if rc != 0:
        raise RuntimeError(f"stationary_gram kernel launch failed: cudaError {rc}")
    stationary_gram.launches += 1
    key = (kind, rows, m, n, d)
    stationary_gram.by_shape[key] = stationary_gram.by_shape.get(key, 0) + 1
    return out


def _rowwise(t, rows):
    """A per-row scalar (``var``, ``alpha``) shaped to broadcast over each
    row's (m, n) gram: () stays (), (R,) becomes (R, 1, 1)."""
    return t if t is None or rows is None else t.reshape(rows, 1, 1)


def _plain_form(kind, x1, x2, rate, var, extra=None, exact=True):
    """The plain PyTorch version: ``var * k(0.5 * weighted_sqdist)`` with the
    distance summed feature by feature, as the kernel sums it (no
    ``|s1|^2 + |s2|^2 - 2 s1.s2`` cancellation: at coordinates ~1e2 that
    cancellation alone moves a float32 posterior std by ~3e-5 relative);
    ``exact=False`` takes the norm decomposition on centred inputs (the TPU
    package's ``_xla_form``).  A (R, d) ``rate`` with (R,) ``var`` and
    ``extra`` gives (R, m, n)."""
    rows = rate.shape[0] if rate.ndim == 2 else None
    dm = 0.5 * weighted_sqdist(x1, x2, rate, exact=exact)
    return _rowwise(var, rows) * _KFORMS[kind](dm, _rowwise(extra, rows))


# K1 as a registered operator: the gram of (m, d) or (R, m, d) ``x1`` and
# ``x2`` at a (d,) or (R, d) ``rate`` (see :func:`stationary_gram`), the
# launch on CUDA tensors and the plain form on CPU tensors.  A
# ``torch.library.Library`` definition dispatches in about half the host
# time of a ``custom_op`` one.
_LIB = torch.library.Library("g3py_tpu_torch", "DEF")
_LIB.define("stationary_gram(str kind, Tensor x1, Tensor x2, Tensor rate, Tensor var, "
            "Tensor? extra) -> Tensor")


def _gram_op_cpu(kind, x1, x2, rate, var, extra):
    return _plain_form(kind, x1, x2, rate, var, extra)


def _prepare(x1, x2, rate):
    """The kernel's inputs: ``x1`` and ``x2`` scaled by a (d,) or (R, d)
    ``rate`` and centred on one mean, as contiguous (R, m, d) and (R, n, d)
    tensors (R = 1 for a (d,) rate)."""
    r = rate[None] if rate.ndim == 1 else rate  # (R, d)
    s1 = x1 * r[:, None, :]
    s2 = x2 * r[:, None, :]
    center = 0.5 * (s1.mean(dim=-2) + s2.mean(dim=-2))[:, None, :]
    return (s1 - center).contiguous(), (s2 - center).contiguous()


def _gram_op_cuda(kind, x1, x2, rate, var, extra):
    out = _launch(kind, *_prepare(x1, x2, rate), var, extra)
    return out[0] if rate.ndim == 1 else out


_LIB.impl("stationary_gram", _gram_op_cpu, "CPU")
_LIB.impl("stationary_gram", _gram_op_cuda, "CUDA")


@torch.library.register_fake("g3py_tpu_torch::stationary_gram", lib=_LIB)
def _gram_op_fake(kind, x1, x2, rate, var, extra):
    return x1.new_empty(rate.shape[:-1] + (x1.shape[-2], x2.shape[-2]))


class _StationaryGram(torch.autograd.Function):
    """Kernel forward (the registered operator); backward through the
    autograd of the norm-decomposition form, as the TPU package's
    ``_gram_hybrid`` replays its XLA form's vjp: one matmul and a few (m, n)
    passes, where the feature-by-feature form's graph takes d of them (+16%
    on logp+dlogp at n=16384 on the card)."""

    @staticmethod
    def forward(ctx, kind, x1, x2, rate, var, extra):
        out = torch.ops.g3py_tpu_torch.stationary_gram(kind, x1, x2, rate, var, extra)
        ctx.kind = kind
        ctx.save_for_backward(x1, x2, rate, var, extra)
        return out

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[1:]
        leaves = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = _plain_form(ctx.kind, *leaves, exact=False)
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, *(next(grads) if need else None for need in needs))


def stationary_gram(kind, x1, x2, rate, var, extra=None):
    """``var * k(0.5 * sum_d (x1_d - x2_d)^2 rate_d^2)`` as an (m, n) matrix.

    ``kind`` is one of ``KINDS``; ``extra`` is the RQ alpha.  With a (R, d)
    ``rate``, ``var`` and ``extra`` are (R,), or 0-d for one value shared by
    every row, and the result is the (R, m, n) stack of every row's gram
    (``x1`` and ``x2`` may then carry the row axis too).  CPU tensors take
    the plain version; CUDA tensors launch the kernel (and raise if it
    cannot be built or launched).  Under ``torch.export`` a CPU tensor takes
    the operator's route too, so that the registered operator is recorded
    whatever the device."""
    if kind not in KINDS:
        raise ValueError(f"stationary_gram: unknown kind {kind!r}")
    if rate.ndim == 1 and max(x1.ndim, x2.ndim) > 2:
        raise ValueError("stationary_gram: inputs with a row axis need a (R, d) rate")
    rows = rate.shape[:-1]
    # a fixed amplitude (a KernelProd's pinned 1, a constant) beside a rate
    # of R rows is one value for all of them
    if var.ndim == 0 and rows:
        var = var.expand(rows)
    if extra is not None and extra.ndim == 0 and rows:
        extra = extra.expand(rows)
    if x1.device.type == "cpu" and not torch.compiler.is_exporting():
        return _plain_form(kind, x1, x2, rate, var, extra)
    if x1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stationary_gram: no kernel for device {x1.device}")
    return _StationaryGram.apply(kind, x1, x2, rate, var, extra)


stationary_gram.launches = 0
#: the launches by (kind, R, m, n, d), beside their total
stationary_gram.by_shape = {}
