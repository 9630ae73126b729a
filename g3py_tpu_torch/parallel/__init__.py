"""Multi-rank parallelism over ``torch.distributed`` (the PyTorch
counterpart of :mod:`g3py_tpu.parallel`).

The JAX package partitions one program over ``jax.devices()``; the port
runs one process a shard (``torchrun --nproc_per_node=D``, or
:func:`~g3py_tpu_torch.parallel.launch.run_local`), each calling the same
function, and meets the other ranks in :mod:`.mesh`'s collectives:

* data parallelism over the training rows of the exact gram — the
  band-sharded Cholesky, solves and trainable NLL of :mod:`.cholesky`
  (``nll_distributed``, ``find_MAP(engine='distributed')``,
  ``predictor_distributed``);
* chain parallelism — the walker-split stretch move and the
  temperature-split parallel tempering of :mod:`.sharded`;
* embarrassing parallelism — the fan-out's (split, start) pairs split over
  the ranks (``lbfgs_fanout_sharded``).

Without a process group every mesh is a mesh of one and no collective
runs.
"""

from .mesh import make_mesh, data_sharding, replicate
from .sharded import sharded_logp_fn, sharded_ensemble_step, pt_sampler_sharded
from .cholesky import (distributed_cholesky, distributed_trsm, distributed_gp_nll,
                       distributed_quad_logdet, distributed_posterior)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicate",
    "sharded_logp_fn",
    "sharded_ensemble_step",
    "pt_sampler_sharded",
    "distributed_cholesky",
    "distributed_trsm",
    "distributed_gp_nll",
    "distributed_quad_logdet",
    "distributed_posterior",
]
