"""Fan-out training: every (data split, start point) pair at once (the
PyTorch counterpart of :mod:`g3py_tpu.bayesian.fanout`).

The ``Experiment`` harness trains one model per simulation split per start.
Here the whole grid is one batched optimization:

* a split is a {0,1} inclusion mask over one fixed observation set, and
  ``th_loglike_masked_fn`` makes the exact loglike a function of the mask
  at one shape (identity-row gram surgery, models/gaussian.py);
* every (mask, start) pair is a row of one batched L-BFGS
  (:func:`~g3py_tpu_torch.bayesian.optimize_jax.lbfgs_maximize`), whose
  line searches hand the objective the rows still searching, each with its
  own mask: an evaluation is one batched K1 and one batched K2 call over
  those rows.

A pair stops at max|g| <= ``tol``, at ``max_iters``, or where its step
lands on a non-finite point (the point is kept and its gradient zeroed).
With ``shard=True`` the pairs are split over the ranks of a mesh
(:func:`lbfgs_fanout_sharded`): each rank runs its share as the rows of
its own batched L-BFGS, and the results are all-gathered.
"""

import functools

import numpy as np
import torch

from ..config import settings
from ..utils import DictObj
from .optimize_jax import lbfgs_maximize

__all__ = ["lbfgs_fanout", "lbfgs_fanout_sharded", "fit_splits"]


def lbfgs_fanout(obj_fn, starts, masks, max_iters, tol):
    """Maximize ``obj_fn(u, w)`` (u (R, ndim) rows, w their (R, n) mask rows
    -> (R,)) from every row of ``starts`` with the paired row of ``masks``,
    all pairs as rows of one batched L-BFGS.  Returns host arrays (points
    (P, ndim), values (P,))."""
    w = torch.as_tensor(np.array(masks, settings.floatx), device=settings.device)
    return lbfgs_maximize(lambda u, rows: obj_fn(u, w[rows]), starts, max_iters=max_iters,
                          tol=tol, with_rows=True)


def lbfgs_fanout_sharded(obj_fn, starts, masks, max_iters=200, tol=1e-5, mesh=None):
    """:func:`lbfgs_fanout` with the pairs split over every rank of
    ``mesh`` (the default mesh when None): the pair count is padded to a
    multiple of the ranks (with copies of the last pair), each rank
    optimizes its equal share as the rows of one batched L-BFGS, and the
    shares are all-gathered.  Every rank calls it alike and gets every
    pair's (points (P, ndim), values (P,)), host arrays."""
    from ..parallel.mesh import make_mesh, all_gather

    if mesh is None:
        mesh = make_mesh()
    ndev = int(np.prod(mesh.devices.shape))
    starts = np.asarray(starts, settings.floatx)
    masks = np.asarray(masks, settings.floatx)
    p = len(starts)
    pad = (-p) % ndev
    if pad:
        starts = np.concatenate([starts, np.repeat(starts[-1:], pad, 0)])
        masks = np.concatenate([masks, np.repeat(masks[-1:], pad, 0)])
    per = len(starts) // ndev
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    pts, vals = lbfgs_fanout(obj_fn, starts[mine], masks[mine], max_iters, tol)
    both = torch.cat([torch.as_tensor(np.asarray(pts), device=mesh.device),
                      torch.as_tensor(np.asarray(vals), device=mesh.device)[:, None]], dim=1)
    both = all_gather(mesh, both, axis=None).cpu().numpy()
    return both[:p, :-1], both[:p, -1]


def fit_splits(process, masks, start=None, points=4, max_iters=200, tol=1e-5,
               noise_mult=0.2, seed=0, shard=False, mesh=None, return_points=False,
               pair_chunk=None):
    """MAP-train a GP-family process on every observation split at once.

    ``masks``: (S, n_obs) {0,1} inclusion rows over the process's observed
    data.  ``points`` start vectors (the given or default start, then
    multiplicative perturbations from ``np.random.default_rng(seed)``, as
    the JAX package draws them) are paired with every split, and all S x
    points optimizations run as rows of one batched L-BFGS.  ``pair_chunk``
    runs the pairs in chunks of that many rows (to bound the batched
    grams' memory).  Not supported with ``fix_vars``; ``shard=True`` splits
    each chunk's pairs over the ranks of ``mesh`` (every rank calling it
    alike, :func:`lbfgs_fanout_sharded`).

    Returns ``(params_list, values)``: the per-split best-start
    natural-space params dicts and the (S, points) final logp matrix; with
    ``return_points`` also the (S, points, ndim) unconstrained points."""
    reg = process.active
    if reg.fixed_datatrace is not None:
        raise ValueError("fit_splits does not support fix_vars")
    like = process.th_loglike_masked_fn()
    _, inputs, outputs = process._resolve_data(None, None, None)

    def obj(u, w):
        p = reg.array_to_dict_tensor(u)
        return reg.logp_prior_dict(p) + reg.logp_potentials(p) + like(p, inputs, outputs, w)

    if start is None:
        start = process.params_default
    base = (reg.dict_to_array(process.filter_params(start)) if isinstance(start, dict)
            else np.asarray(start))
    base = np.asarray(base, settings.floatx)
    rng = np.random.default_rng(seed)
    starts = np.stack([base] + [
        base * (1 + noise_mult * rng.standard_normal(base.shape)).astype(settings.floatx)
        for _ in range(points - 1)])                                    # (K, ndim)
    masks = np.asarray(masks, settings.floatx)
    if masks.ndim == 1:
        masks = masks[None, :]
    S, K = len(masks), len(starts)
    u0 = np.broadcast_to(starts[None], (S, K, base.size)).reshape(S * K, -1)
    wv = np.broadcast_to(masks[:, None, :], (S, K, masks.shape[1])).reshape(S * K, -1)
    chunk = len(u0) if pair_chunk is None else int(pair_chunk)
    fan = functools.partial(lbfgs_fanout_sharded, mesh=mesh) if shard else lbfgs_fanout
    parts = [fan(obj, u0[lo:lo + chunk], wv[lo:lo + chunk], max_iters, tol)
             for lo in range(0, len(u0), chunk)]
    pts = np.concatenate([p for p, _ in parts]).reshape(S, K, -1)
    vals = np.concatenate([v for _, v in parts]).reshape(S, K)
    best = vals.argmax(axis=1)
    params_list = [DictObj(reg.array_to_dict(pts[i, best[i]])) for i in range(S)]
    if return_points:
        return params_list, vals, pts
    return params_list, vals
