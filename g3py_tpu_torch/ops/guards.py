"""Numeric sanitizer guards (the PyTorch counterpart of
:mod:`g3py_tpu.ops.guards`): NaN/Inf replacement, covariance diagonal
repair and clipping."""

import torch

__all__ = ["to_num", "inf_to_num", "to_cov", "to_bounded"]

_BIG = 1e10


def to_num(x, nan=0.0, posinf=_BIG, neginf=-_BIG):
    """NaN -> 0, Inf -> +-1e10."""
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def inf_to_num(x, posinf=_BIG, neginf=-_BIG):
    """Inf -> +-1e10, NaN left alone."""
    x = torch.where(torch.isposinf(x), torch.full_like(x, posinf), x)
    return torch.where(torch.isneginf(x), torch.full_like(x, neginf), x)


def to_cov(x, jitter=1e-6):
    """Repair a covariance candidate: sanitize NaN/Inf and, when any
    diagonal entry is <= 0, add ``(jitter - min(diag)) * I`` (each matrix
    of a (R, n, n) stack on its own)."""
    x = to_num(x)
    dmin = torch.diagonal(x, dim1=-2, dim2=-1).min(dim=-1).values
    bump = torch.where(dmin <= 0.0, jitter - dmin, torch.zeros_like(dmin))
    return x + bump[..., None, None] * torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)


def to_bounded(x, lower=None, upper=None):
    """Clip to [lower, upper]."""
    return torch.clamp(x, min=lower, max=upper)
