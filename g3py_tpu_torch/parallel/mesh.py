"""The device mesh of the port: ranks of a ``torch.distributed`` process
group, and the collectives every sharded module calls.

The JAX package runs one controller over ``jax.devices()`` and partitions
a program with ``shard_map``.  The port is SPMD instead, in the
``torchrun`` idiom: one process (rank) per shard, each calling the same
function on its own band of the data, the ranks meeting only in the
collectives of this module (:func:`psum`, :func:`all_gather`,
:func:`permute`, :func:`gather_rows`).
Without an initialized process group a mesh is a mesh of one on
``settings.device`` — the band code runs with D = 1 and no collective, as
the JAX package's does on a one-device host.

Backends: NCCL takes device tensors, one card a rank; gloo takes CPU
tensors and, with torch 2.11 (CUDA 12.8) on an NVIDIA H100, CUDA tensors
for every op here (``all_reduce``, ``all_gather_into_tensor``; also
``broadcast``, ``reduce``, ``reduce_scatter_tensor``: ``python3 -m
g3py_tpu_torch.tools.dist_smoke --probe``), copying through host memory
itself, although torch's backend table lists only ``broadcast`` and
``all_reduce`` for gloo on the GPU.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..config import settings, as_tensor

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicate", "psum", "all_gather", "permute",
           "gather_rows", "band_rows"]


class Mesh:
    """Ranks of a process group laid out on named axes.

    * ``shape[axis]`` is the axis's size (as a JAX mesh's ``shape``);
      ``devices`` is the (shape) array of global ranks and ``size`` their
      number (``lbfgs_fanout_sharded`` reads ``devices.shape``).
    * ``rank`` is this process's rank in the default group;
      :meth:`axis_index` is its coordinate along an axis.
    * ``device`` is ``settings.device`` at construction; ``backend`` the
      process group's backend name (None for a mesh of one without a
      process group)."""

    def __init__(self, axis_names, shape):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.size = self.devices.size
        distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if distributed else 0
        self.device = torch.device(settings.device)
        self.backend = dist.get_backend() if distributed else None
        self._coords = np.unravel_index(self.rank, shape)
        self._groups = {}
        if distributed:
            # one subgroup per axis: the ranks that share every other
            # coordinate (every rank creates every group, in one order)
            for i, name in enumerate(self.axis_names):
                if len(self.axis_names) == 1:
                    self._groups[name] = None  # the default group
                    continue
                moved = np.moveaxis(self.devices, i, -1).reshape(-1, shape[i])
                for ranks in moved:
                    g = dist.new_group([int(r) for r in ranks])
                    if self.rank in ranks:
                        self._groups[name] = g

    def axis_index(self, axis):
        """This rank's coordinate along ``axis`` (its rank in the mesh for
        ``axis=None``, the whole mesh)."""
        if axis is None:
            return self.rank
        return int(self._coords[self.axis_names.index(axis)])

    def axis_size(self, axis):
        return self.size if axis is None else self.shape[axis]

    def axis_group(self, axis):
        """The process group of ``axis`` (None, the default group, for the
        whole mesh)."""
        return None if axis is None else self._groups.get(axis)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def make_mesh(n_devices=None, axis_names=("dp",), shape=None):
    """A 1-D (default) or ``shape``-d mesh over the ranks of the default
    process group (every rank calls it), or a mesh of one when no process
    group is initialized.  ``n_devices`` must equal the group's size."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the process group has "
                         f"{world} rank(s); start one rank per shard (torchrun "
                         "--nproc_per_node=D)")
    shape = (n_devices,) if shape is None else tuple(shape)
    if int(np.prod(shape)) != n_devices or len(shape) != len(axis_names):
        raise ValueError(f"make_mesh: shape {shape} does not lay out {n_devices} rank(s) "
                         f"on axes {tuple(axis_names)}")
    return Mesh(axis_names, shape)


class _Layout:
    """Where an array lives on a mesh: its leading axis split over ``axis``
    (``data_sharding``) or whole on every rank (``replicate``)."""

    def __init__(self, mesh, axis=None, rank=1):
        self.mesh, self.axis, self.rank = mesh, axis, rank

    def place(self, value):
        """This rank's part of ``value`` (rows ``[r n/D, (r+1) n/D)`` of a
        split layout), a tensor on the mesh's device."""
        t = as_tensor(value).to(self.mesh.device)
        if self.axis is None:
            return t
        return band_rows(self.mesh, t, self.axis)

    def __repr__(self):
        return f"Layout(axis={self.axis!r}, rank={self.rank})"


def data_sharding(mesh, axis="dp", rank=2):
    """The layout that splits the leading (data) axis over ``axis``."""
    return _Layout(mesh, axis, rank)


def replicate(mesh):
    """The layout that keeps an array whole on every rank."""
    return _Layout(mesh)


def band_rows(mesh, t, axis="dp"):
    """Rows ``[r n/D, (r+1) n/D)`` of ``t`` for this rank ``r`` of ``D``."""
    d = mesh.axis_size(axis)
    if t.shape[0] % d:
        raise ValueError(f"{t.shape[0]} rows do not split over the {d} ranks of axis {axis!r}")
    rows = t.shape[0] // d
    r = mesh.axis_index(axis)
    return t[r * rows:(r + 1) * rows]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def psum(mesh, t, axis="dp"):
    """The sum of ``t`` over the ranks of ``axis`` (an all_reduce; every
    rank of the mesh for ``axis=None``), on every rank; ``t`` itself on an
    axis of one."""
    if mesh.axis_size(axis) == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.axis_group(axis))
    return out


def all_gather(mesh, t, axis="dp"):
    """The ranks' ``t`` of ``axis`` concatenated along the leading axis in
    rank order, on every rank."""
    d = mesh.axis_size(axis)
    if d == 1:
        return t
    t = t.contiguous()
    out = torch.empty((d * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=mesh.axis_group(axis))
    return out


def permute(mesh, t, shift, axis="dp"):
    """The ``t`` of the rank ``shift`` places before this one along
    ``axis`` (cyclic): the counterpart of ``lax.ppermute`` with the
    permutation ``i -> i + shift``.  It rides on :func:`all_gather` (the
    axes it serves, temperatures, are a handful of ranks)."""
    d = mesh.axis_size(axis)
    if d == 1:
        return t
    gathered = all_gather(mesh, t[None], axis)
    return gathered[(mesh.axis_index(axis) - shift) % d]


def gather_rows(mesh, band, axis="dp"):
    """The whole row-banded matrix (or vector) on every rank."""
    return all_gather(mesh, band, axis)
