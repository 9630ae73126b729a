"""g3py_tpu_torch — the PyTorch/CUDA port of g3py_tpu.

Exact GP and warped-GP regression served from one factorization, with the
fused stationary gram as a hand-written CUDA kernel for Hopper (sm_90a).
It imports neither JAX nor g3py_tpu.  Tensors live on
``settings.device`` ("cpu" unless the program sets "cuda"):

>>> import g3py_tpu_torch as g3t
>>> g3t.settings.device = "cuda"
>>> gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x))
>>> gp.observed(x, y)
>>> gp.logp()
>>> pr = gp.predictor()
>>> pr(x_query, quantiles=True, quantiles_noise=True)
"""

from . import config
from .config import settings, floatx, set_floatx
from .utils import DictObj, params_from_jax
from .ops import (safe_cholesky, cho_solve, solve_lower_triangular,
                  gauss_hermite, stationary_gram)
from .hypers import (Hypers, Param, Prior, Flat, FlatExp, Transform,
                     IdentityTransform, LogTransform)
from .hypers.metrics import Metric, Delta, ARD, ARD_L2
from .hypers.kernels import (Kernel, KernelStationary, KernelComposition,
                             KernelSum, KernelNoise,
                             KernelStationaryExponential, SE, MAT32, MAT52, RQ)
from .hypers.means import Mean, Zero, Bias
from .hypers.mappings import Mapping, Identity, BoxCoxLinear
from .bayesian import GraphicalModel
from .models import (StochasticProcess, EllipticalProcess, GaussianProcess,
                     WarpedGaussianProcess, GP, WGP, Predictor)

__version__ = "0.1.0"
