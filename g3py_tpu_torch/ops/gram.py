"""Pairwise (gram) tensor builders.

The PyTorch counterpart of :mod:`g3py_tpu.ops.gram`:

* :func:`weighted_sqdist` — ARD-L2 distances by the norm decomposition
  ``|s1|^2 + |s2|^2 - 2 s1.s2`` with ``s = x * rate``, on inputs centred
  first, clamped at zero; ``exact=True`` sums per-feature slabs instead.
* :func:`weighted_dot` — ``sum_d x1_d x2_d w_d`` as one matmul.
* :func:`pairwise_sum` / :func:`pairwise_prod` — the d-axis sum (product)
  of an elementwise pair function, one (N, M) slab per feature, never an
  N x M x d tensor.

The accumulator follows the input dtype: float64 inputs stay float64.
:func:`weighted_sqdist` takes a batch of rates (R, d), and inputs with a
leading row axis, and then returns (R, N, M); so do :func:`weighted_dot`
and the pairwise reductions, whose per-dimension vectors may be (R, d).
Float32 products stay full float32 (TF32 is off, see :mod:`..config`).
"""

import torch

__all__ = ["weighted_sqdist", "sqdist", "weighted_dot", "pairwise_sum", "pairwise_prod"]


def _as2d(x):
    return x[:, None] if x.ndim == 1 else x


def weighted_sqdist(x1, x2, rate=None, exact=False):
    """sum_d (x1_d - x2_d)^2 * rate_d^2 as an (N, M) matrix; (R, N, M) for
    a (R, d) ``rate`` or inputs with a leading row axis, each row centred
    on its own."""
    x1, x2 = _as2d(x1), _as2d(x2)
    if rate is not None:
        s1, s2 = x1 * rate[..., None, :], x2 * rate[..., None, :]
    else:
        s1, s2 = x1, x2
    if exact:
        return pairwise_sum(s1, s2, lambda a, b: (a - b) ** 2)
    center = (0.5 * (s1.mean(dim=-2) + s2.mean(dim=-2))).detach()[..., None, :]
    s1 = s1 - center
    s2 = s2 - center
    n1 = (s1 * s1).sum(dim=-1)
    n2 = (s2 * s2).sum(dim=-1)
    d = n1[..., :, None] + n2[..., None, :] - 2.0 * torch.matmul(s1, s2.transpose(-1, -2))
    return torch.clamp(d, min=0.0)


def sqdist(x1, x2):
    """Unweighted squared euclidean distances."""
    return weighted_sqdist(x1, x2, None)


def weighted_dot(x1, x2, weight=None):
    """sum_d x1_d x2_d w_d as an (N, M) matmul (ARD_Dot); the weight folds
    into one operand."""
    x1, x2 = _as2d(x1), _as2d(x2)
    if weight is not None:
        x1 = x1 * torch.as_tensor(weight, dtype=x1.dtype, device=x1.device)
    return torch.matmul(x1, x2.transpose(-1, -2))


def _pairwise_reduce(x1, x2, elem_fn, combine, init, per_dim=()):
    """Reduce ``elem_fn(x1_d, x2_d, *w_d)`` over the feature axis keeping
    only an (N, M) slab alive per step — never N x M x d.  ``per_dim``
    entries are (d,) vectors, or (R, d) for R rows, whose d-th entry goes to
    ``elem_fn`` beside the d-th feature columns (as (R, 1, 1))."""
    x1, x2 = _as2d(x1), _as2d(x2)
    d = x1.shape[-1]
    per_dim = [torch.as_tensor(w, dtype=x1.dtype, device=x1.device) for w in per_dim]
    per_dim = [torch.broadcast_to(w, w.shape[:-1] + (d,)) if w.ndim else w.expand(d)
               for w in per_dim]
    rows = torch.broadcast_shapes(x1.shape[:-2], x2.shape[:-2],
                                  *(w.shape[:-1] for w in per_dim))
    acc = torch.full(rows + (x1.shape[-2], x2.shape[-2]), init, dtype=x1.dtype,
                     device=x1.device)
    for k in range(d):
        acc = combine(acc, elem_fn(x1[..., :, k, None], x2[..., None, :, k],
                                   *(w[..., k, None, None] for w in per_dim)))
    return acc


def pairwise_sum(x1, x2, elem_fn, *per_dim):
    """sum_d elem_fn(x1[:, d] against x2[:, d], *w_d) as (N, M); inputs
    with a leading row axis give (R, N, M)."""
    return _pairwise_reduce(x1, x2, elem_fn, torch.add, 0.0, per_dim)


def pairwise_prod(x1, x2, elem_fn, *per_dim):
    """prod_d elem_fn over the features as (N, M)."""
    return _pairwise_reduce(x1, x2, elem_fn, torch.mul, 1.0, per_dim)
