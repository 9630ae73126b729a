"""g3py_tpu_torch — the PyTorch/CUDA port of g3py_tpu.

Exact GP and warped-GP regression over the reference's whole catalogue of
kernels (with their ``+``/``*`` algebra), metrics, means and warpings, and
the reference's other process families — Student-t (TP/WTP), marginal
(MP), transport (TGP) and copula (CGP/CSTP) — trained (``dlogp``,
``find_MAP``, with scipy or the batched on-device L-BFGS, or matrix-free at
large n, or through the sparse families: the SGPR collapsed bound, the
sparse variational processes over non-gaussian likelihoods and the linear
model of coregionalization; deep kernels over any of them), sampled
(``sample_hypers``:
the ensemble sampler, NUTS, NeuTra or ADVI over the hyperparameter posterior) and served from one factorization or averaged over a datatrace,
with the fused stationary gram and the blocked panel Cholesky as
hand-written CUDA kernels for Hopper (sm_90a), both batched over
hyperparameter rows.
It imports neither JAX nor g3py_tpu.  Tensors live on ``settings.device``,
the card (``"cuda"``) unless the program says ``"cpu"``.  The datatrace
toolkit (densities, clusters, errors, candidates; ``.npz`` files) and the
``Experiment`` model-selection harness (with its fused split-training
grid), Bayesian optimization (``BayesOpt``), kernel structure search
(``search_kernel``), the dataset loaders, checkpoints and plots run on the
host around them (matplotlib is imported only by a call that draws).
Across ranks of ``torch.distributed`` (:mod:`.parallel`), the exact GP
and Student-t objectives are band-sharded (``nll_distributed``,
``find_MAP(engine='distributed')``, ``predictor_distributed``) and the
samplers and the fan-out split over the ranks.  The host-facing
statistics (``predict``, ``mean``, a predictor's call, ...) return host
numpy arrays:

>>> import g3py_tpu_torch as g3t
>>> gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x))
>>> gp.observed(x, y)
>>> params = gp.find_MAP(points=2, display=False)
>>> pr = gp.predictor(params)
>>> pr(x_query, quantiles=True, quantiles_noise=True)
>>> dt = gp.sample_hypers(start=params, samples=400, chains=32)
>>> gp.averaged_predictor(dt, max_rows=16)(x_query)
>>> gp2 = g3t.GP(space=x, location=g3t.Linear(x) + g3t.Bias(),
...               kernel=g3t.SE(x) * g3t.SIN(x) + 2.0 * g3t.MAT52(x) + g3t.LIN(x) + 0.1)
>>> tp = g3t.TP(space=x, location=g3t.Bias(), kernel=g3t.SE(x))
>>> tgp = g3t.TGP(space=x, transport=g3t.TLocation(g3t.Bias(x))
...               @ g3t.TKernel(g3t.SE(x), noisy=True))
>>> cgp = g3t.CGP(space=x, kernel=g3t.SE(x),
...               marginal=g3t.Normal(mu=g3t.Bias(x), sigma=g3t.Bias(x, name="S")))

Only the numeric core (``config``, ``utils``, ``ops``) is imported with the
package; the catalogue, the models and the Bayesian layer load at the first
use of any other name (``g3t.GP``, ``g3t.SE``, ...), so that a serving
process (:mod:`g3py_tpu_torch.serving`) loads no model code.
"""

import importlib

from . import config
from .config import settings, floatx, set_floatx
from .utils import (DictObj, MaxTime, clone, nan_to_high, save_pkl, load_pkl, save_datatrace,
                    load_datatrace, save_json, random_state, params_from_jax, flow_from_jax)
from .utils.data import (save_csv, load_csv, datasets_path, data_sunspots, data_co2,
                         data_engel, data_heart, data_eurusd, data_abalone, data_creep,
                         data_ailerons, data_rivers, random_obs, uniform_obs)
from .utils.plots import (subplot, tight_layout, style_text, figure, plot, show, plot_text,
                          plot_save, plot_img, show_img, plot_matrix, grid2d, plot_2d,
                          style_seaborn, style_normal, style_big, style_big_seaborn,
                          style_widget)
from .utils.checkpoint import save_checkpoint, load_checkpoint
from .utils.datatrace import Datatrace
from .ops import (safe_cholesky, cho_solve, solve_lower_triangular,
                  solve_upper_triangular, trtri_from_panels, mvn_quad_logdet,
                  gauss_hermite, stationary_gram, panel_cholesky, newton_inverse)
from .ops.special import betainc, gammaln, ndtri, ndtr
from . import parallel

__version__ = "0.1.0"
_loaded = False


def _load():
    """Import the catalogue, the models and the Bayesian layer and publish
    their names here (the reference's names from :mod:`.compat` too)."""
    global _loaded
    if _loaded:
        return
    _loaded = True  # the imports below look names up on this package
    try:
        _import_all()
    except BaseException:
        _loaded = False  # the next use raises the import's error again
        raise


def _import_all():
    from .hypers import (Hypers, Param, Prior, Flat, FlatExp, Transform,
                         IdentityTransform, LogTransform, LogIdTransform, IntervalTransform,
                         Freedom, ExpFlat, FlatPos, PositiveFlat, NonTransformLog, FlatExpId,
                         Exponential, Uniform as UniformPrior, Null)
    from .hypers.metrics import (Metric, One, Delta, DeltaEq, DeltaEq2, Minimum, Difference, L1,
                                 L2, ARD, ARD_L1, ARD_L2, ARD_Dot, ARD_DotBias, PSD, PSD_Dot,
                                 PSD_L2)
    from .hypers.kernels import (Kernel, KernelDot, KernelStationary, KernelOperation,
                                 KernelComposition, KernelSum, KernelProd, KernelScale,
                                 KernelShift, KernelMax, KernelEquals, KernelEquals2, KernelNoise,
                                 BW, VAR, NIL, LIN, POL, NN, WN, RQ, MAT32, MAT52,
                                 KernelStationaryExponential, OU, SE, KernelPeriodic, COS, SIN,
                                 SINC, SM)
    from .hypers.features import DeepKernel
    from .hypers.means import (Mean, Location, BlackBox, MeanOperation, MeanComposition,
                               MeanScale, MeanShift, MeanProd, MeanSum, Zero, Bias, Linear, Power)
    from .hypers.mappings import (Mapping, MappingOperation, MappingComposed, MappingInvSum,
                                  Identity, LinearMapping, LogShifted, BoxCoxShifted, BoxCoxLinear,
                                  BoxCoxLinear2, WarpingTanh, WarpingBoxCox, ArcsinhLinear,
                                  SinhArcsinh, Logistic)
    from .hypers.transports import (Transport, TransportOperation, TransportComposed, ID,
                                    TElemwise, TLinear, TNoLinear, TLocation, TScale, TMapping,
                                    TKernel, TTriangular)
    from .bayesian import (GraphicalModel, Model, get_model, optimize, ensemble_sampler,
                           pt_sampler, default_beta_ladder, mcmc_ensemble, hmc_sampler,
                           nuts_sampler, nuts_warmup, fit_flow, flow_forward, flow_inverse,
                           neutra_logp, neutra_nuts, fit_advi, advi_draws, lbfgs_maximize,
                           lbfgs_fanout, lbfgs_fanout_sharded, fit_splits, BayesOpt,
                           search_kernel, KernelSearch, Experiment, chains_to_datatrace, datatrace_to_chains,
                           datatrace_to_kde, kde_to_datatrace, cluster_datatrace,
                           errors_datatrace, marginal_datatrace, conditional_datatrace,
                           marginal, conditional, find_candidates, gelman_rubin,
                           burn_in_samples, effective_sample_min, effective_sample_size,
                           plot_datatrace, plot_clusters, kde_datatrace, hist_datatrace,
                           scatter_datatrace)
    from .models import (StochasticProcess, EllipticalProcess, GaussianProcess,
                         WarpedGaussianProcess, StudentTProcess, WarpedStudentTProcess,
                         MarginalProcess, Density, SymmetricDensity, Uniform, Normal, StudentT,
                         TransportProcess, TransportGaussianProcess, CopulaProcess,
                         CopulaGaussianProcess, CopulaStudentTProcess, TransformedStudentTProcess,
                         GP, WGP, TP, WTP, MP, TGP, CGP, CSTP, Predictor, AveragedPredictor,
                         IterativePredictor, DistributedPredictor, Likelihood, GaussianLik,
                         StudentTLik, BernoulliLik,
                         PoissonLik, NegBinomialLik, OrdinalLik, CategoricalLik,
                         HeteroscedasticLik, InducingPoints, SparseGaussianProcess,
                         SparseWarpedGaussianProcess, select_inducing, VariationalQ,
                         VariationalQHeads, SparseVariationalProcess, MulticlassSVP,
                         HeteroscedasticSVP, SGP, SWGP, SVP, Mixing, MultiGaussianLik, LMCSVP,
                         with_output, stack_outputs, StateSpaceGP, SSGP, MultiStateSpaceGP,
                         LMCSSGP, SpatioTemporalSSGP, STSSGP, SparseSpatioTemporalSSGP,
                         NonGaussianSSGP, NGSSGP, NonGaussianMultiSSGP, NGMSSGP,
                         NonGaussianSTSSGP, NGSTSSGP, GridGP, grid_rows, SKIGP)
    from .serving import ExportedPredictor, load_predictor
    from .utils.lagrange import LagrangianConstraint, LagrangianMultiplier
    from .utils.debug import debug, show_graph, print_graph, debug_mode, profile_trace, set_debug
    compat = importlib.import_module(__name__ + ".compat")
    names = dict(locals())
    names.update({k: getattr(compat, k) for k in compat.__all__})
    globals().update(names)


def __getattr__(name):
    if name == "__all__":  # ``from g3py_tpu_torch import *`` loads every name
        _load()
        return sorted(k for k in globals() if not k.startswith("_"))
    if name.startswith("__"):
        raise AttributeError(name)
    _load()
    try:
        return globals()[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None


def __dir__():
    _load()
    return sorted(globals())
