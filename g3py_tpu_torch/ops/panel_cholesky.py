"""Blocked panel Cholesky with per-panel inverses: a hand-written CUDA kernel
and its plain version.

``panel_cholesky(a, block) -> (L, dinv, info)``: the lower Cholesky factor
of an SPD (n, n) matrix (zero strict upper triangle), the inverses of its
B x B diagonal panels (``dinv[k] = L_kk^{-1}``, over the identity-padded
``ceil(n/B)`` panels) and a ``cholesky_ex``-style ``info`` (0-dim int32
tensor: 0, or 1 + the first column whose pivot is <= 0 or not finite).
A batch ``(R, n, n)`` gives ``L (R, n, n)``, ``dinv (R, nb, B, B)`` and
``info (R,)``, each row its own first failing column, from ONE launch
sequence on the card (the hyperparameter rows of a sampler step share the
panel loop).
The port of the TPU kernel ``g3py_tpu/ops/pallas_cholesky.py::
_pallas_cholesky``; the CUDA source is ``csrc/panel_cholesky.cu`` and says
what bounds it on the card.  Every factorization of
:func:`~g3py_tpu_torch.ops.linalg.safe_cholesky` goes through it; the panel
inverses seed L^{-1} (:func:`~g3py_tpu_torch.ops.linalg.trtri_from_panels`).

* On a CPU tensor it computes the plain PyTorch version :func:`_plain_form`;
  on a CUDA tensor it launches the kernel or raises.
* ``panel_cholesky.launches`` counts kernel factorizations (and nothing
  else): one per call, whatever the batch.
* The input is only read; a failed factorization is reported in ``info``
  and its L is garbage, as with ``torch.linalg.cholesky_ex``.
"""

import ctypes

import torch

from . import _build

__all__ = ["panel_cholesky", "BLOCK"]

#: panel width B on the card and in the plain version (csrc note: B = 128)
BLOCK = 128


def _check(a, block):
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"panel_cholesky: a square matrix (or a batch of them) is needed, "
                         f"got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"panel_cholesky: float32 or float64, got {a.dtype}")
    if block <= 0 or block % 64 or block > 128:
        raise ValueError(f"panel_cholesky: block must be 64 or 128, got {block}")


def _entry(dtype, lib=None):
    """The C entry point for ``dtype`` in ``lib`` (default: the built
    library), its ctypes signature set."""
    lib = _build.library("panel_cholesky") if lib is None else lib
    fn = getattr(lib, "panel_cholesky_f32" if dtype == torch.float32 else "panel_cholesky_f64")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(a, block, lib=None):
    single = a.ndim == 2
    a = (a[None] if single else a).contiguous()
    rows, n = a.shape[0], a.shape[-1]
    nb = -(-n // block)
    npad = nb * block
    if npad > 64 * 65535:  # one 64-row tile per grid row of the panel product
        raise ValueError(f"panel_cholesky: n={n} exceeds the launch grid")
    if not 1 <= rows <= 65535:  # one grid layer a matrix
        raise ValueError(f"panel_cholesky: a batch of {rows} exceeds the launch grid")
    out = torch.empty((rows, n, n), dtype=a.dtype, device=a.device)
    w = out if npad == n else torch.empty((rows, npad, npad), dtype=a.dtype, device=a.device)
    # a scratch panel for the in-order loop (f64, B = 64); the float lookahead
    # forms its panels in place
    pan = torch.empty((rows, max(npad - block, 1), block), dtype=a.dtype, device=a.device)
    dinv = torch.empty((rows, nb, block, block), dtype=a.dtype, device=a.device)
    info = torch.empty((rows,), dtype=torch.int32, device=a.device)
    fn = _entry(a.dtype, lib)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), pan.data_ptr(),
                dinv.data_ptr(), info.data_ptr(), n, npad, block, rows, stream)
    if rc != 0:
        raise RuntimeError(f"panel_cholesky kernel launch failed: cudaError {rc}")
    panel_cholesky.launches += 1
    return (out[0], dinv[0], info[0]) if single else (out, dinv, info)


def _plain_form(a, block=BLOCK):
    """The plain PyTorch version: the same right-looking panel loop on an
    identity-padded copy — factor the diagonal tile (``cholesky_ex``),
    invert it, form the panel below by a product with the inverse, update
    the trailing matrix.  A batch is factored row by row."""
    if a.ndim == 3:
        parts = [_plain_form(row, block) for row in a]
        return tuple(torch.stack(t) for t in zip(*parts))
    n = a.shape[0]
    nb = -(-n // block)
    npad = nb * block
    w = torch.eye(npad, dtype=a.dtype, device=a.device)
    w[:n, :n] = a
    dinv = torch.empty((nb, block, block), dtype=a.dtype, device=a.device)
    eye = torch.eye(block, dtype=a.dtype, device=a.device)
    infos = []
    for k in range(nb):
        s = slice(k * block, (k + 1) * block)
        # the identity padding is decoupled: factor the real part only, so
        # that n <= block is exactly cholesky_ex(a)
        m = min(block, n - s.start)
        lkk = eye.clone()
        lkk[:m, :m], inf = torch.linalg.cholesky_ex(w[s.start:s.start + m, s.start:s.start + m])
        infos.append(inf)
        w[s, s] = lkk
        dinv[k] = torch.linalg.solve_triangular(lkk, eye, upper=False)
        below = torch.matmul(w[s.stop:, s], dinv[k].T)
        w[s.stop:, s] = below
        w[s.stop:, s.stop:] -= torch.matmul(below, below.T)
    # first failing panel, in the caller's columns; no host sync
    local = torch.stack(infos).to(torch.int64)
    first = torch.where(local > 0, local + torch.arange(nb, device=a.device) * block,
                        torch.full_like(local, npad + 1)).min()
    info = torch.where(first > npad, torch.zeros_like(first), first).to(torch.int32)
    return torch.tril(w[:n, :n]), dinv, info


def panel_cholesky(a, block=BLOCK):
    """``(L, dinv, info)`` of an SPD (n, n) float32/float64 matrix, or of
    each matrix of an (R, n, n) batch (see the module docstring).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (and raise if it cannot be built or launched)."""
    _check(a, block)
    if a.device.type == "cpu":
        return _plain_form(a, block)
    if a.device.type != "cuda":
        raise ValueError(f"panel_cholesky: no kernel for device {a.device}")
    return _launch(a, block)


panel_cholesky.launches = 0
