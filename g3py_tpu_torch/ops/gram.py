"""Pairwise (gram) tensor builders.

The PyTorch counterpart of :mod:`g3py_tpu.ops.gram`:

* :func:`weighted_sqdist` — ARD-L2 distances by the norm decomposition
  ``|s1|^2 + |s2|^2 - 2 s1.s2`` with ``s = x * rate``, on inputs centred
  first, clamped at zero; ``exact=True`` sums per-feature slabs instead.
* :func:`pairwise_sum` — the d-axis sum of an elementwise pair function,
  one (N, M) slab per feature, never an N x M x d tensor.

The accumulator follows the input dtype: float64 inputs stay float64.
:func:`weighted_sqdist` takes a batch of rates (R, d), and inputs with a
leading row axis, and then returns (R, N, M).
"""

import torch

__all__ = ["weighted_sqdist", "sqdist", "pairwise_sum"]


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


def pairwise_sum(x1, x2, elem_fn, *per_dim):
    """sum_d elem_fn(x1[:, d] against x2[:, d], *w_d) as (N, M); inputs
    with a leading row axis give (R, N, M)."""
    x1, x2 = _as2d(x1), _as2d(x2)
    d = x1.shape[-1]
    per_dim = tuple(torch.broadcast_to(torch.as_tensor(w, dtype=x1.dtype, device=x1.device), (d,))
                    for w in per_dim)
    acc = torch.zeros(torch.broadcast_shapes(x1.shape[:-2], x2.shape[:-2])
                      + (x1.shape[-2], x2.shape[-2]), dtype=x1.dtype, device=x1.device)
    for k in range(d):
        acc = acc + elem_fn(x1[..., :, k, None], x2[..., None, :, k], *(w[k] for w in per_dim))
    return acc
