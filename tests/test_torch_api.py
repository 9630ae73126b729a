"""The port's entry points take the JAX package's arguments: the same
keywords, the positional ones in the same order (a call written for the
JAX package runs on the port, or raises the ``NotImplementedError`` that
names the ROADMAP item which brings the option).

Each pair is checked by signature — every named parameter of the JAX
callable exists in the port's, a positional one at the same position — and
a sample of them is called with the JAX package's keywords and positional
order."""

import inspect
import os
import tempfile

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.bayesian import advi as jadvi, neutra as jneutra, nuts as jnuts
from g3py_tpu.bayesian import optimize_jax as jlbfgs, samplers as jsam
from g3py_tpu.bayesian.selection import optimize as jopt
from g3py_tpu.ops import iterative as jit_ops, linalg as jla, rff as jrff
from g3py_tpu.ops.root import newton_inverse as jnewton
import g3py_tpu.utils as jutils
from g3py_tpu.utils import data as jdata, reference_io as jio
from g3py_tpu_torch.bayesian import neutra as tneutra, samplers as tsam
from g3py_tpu_torch.bayesian.selection import optimize as topt
from g3py_tpu_torch.bayesian import optimize_jax as tlbfgs
from g3py_tpu_torch.ops import iterative as tit_ops, linalg as tla, rff as trff
from g3py_tpu_torch.ops.root import newton_inverse as tnewton
import g3py_tpu_torch.utils as tutils
from g3py_tpu_torch.utils import data as tdata, reference_io as tio

import torch_parity  # noqa: F401  (puts the port on the CPU)

PROCESS_METHODS = ["set_space", "observed", "logp", "loglike", "dlogp", "logp_chain",
                   "find_MAP", "sample_hypers", "predict", "quantiler", "sampler", "scores",
                   "sample", "batch_predict", "average", "predictor", "averaged_predictor",
                   "loo", "posterior_state", "th_loo_fn", "fixed_logp", "fixed_dlogp",
                   "fixed_loglike", "fixed_logprior", "batch_sample", "particles",
                   "clustered_predictors", "eval_params",
                   "th_logpredictive", "th_median", "th_covariance", "th_kernel",
                   "th_cholesky", "th_cholesky_diag", "th_mean", "th_variance",
                   "nll_iterative", "predictor_iterative", "_find_map_iterative",
                   "params_random", "params_datatrace", "transform_params", "params_process",
                   "th_cross_mean", "th_error_l1", "th_error_l2", "th_error_mse",
                   "th_mapping_inv", "th_define_process"]
STATISTICS = ["mean", "median", "variance", "std", "covariance", "logpredictive", "mapping",
              "location", "kernel", "cholesky", "kernel_diag", "kernel_sd", "cholesky_diag",
              "cross_mean", "error_l1", "error_l2", "error_mse", "mapping_inv"]
ITERATIVE_OPS = ["cg_solve", "slq_logdet", "lazy_kernel_matvec", "iterative_gp_nll",
                 "pivoted_cholesky", "woodbury_preconditioner", "pcg_solve",
                 "preconditioned_gp_nll"]
ITERATIVE_PREDICTOR = ["__init__", "predict", "sampler", "mean", "std", "variance",
                       "quantiler", "median", "logpredictive"]

TOOLKIT = ["datatrace_to_kde", "kde_to_datatrace", "cluster_datatrace", "errors_datatrace",
           "marginal_datatrace", "conditional_datatrace", "marginal", "conditional",
           "find_candidates", "plot_datatrace", "plot_clusters", "kde_datatrace",
           "hist_datatrace", "scatter_datatrace"]
UTILS = ["save_pkl", "load_pkl", "save_datatrace", "load_datatrace", "save_json", "clone",
         "random_state"]
EXPERIMENT = ["__init__", "add_model", "set_data", "set_scores", "set_selection", "save",
              "new_data", "select_model", "calc_scores", "add_result", "run", "run_fanout",
              "describe", "plot"]
#: item 15's entry points: the fan-out, BO, the structure search, the utils
ITEM15_FUNCS = ["fit_splits", "lbfgs_fanout", "search_kernel", "save_checkpoint",
                "load_checkpoint", "save_csv", "load_csv", "datasets_path", "data_co2",
                "data_engel", "data_heart", "data_eurusd", "data_abalone", "data_creep",
                "data_ailerons", "data_rivers", "subplot", "tight_layout", "style_text",
                "plot_text", "plot_save", "plot_img", "show_img", "plot_matrix", "grid2d",
                "plot_2d", "style_seaborn", "style_normal", "style_big", "style_big_seaborn",
                "style_widget", "debug", "show_graph", "print_graph", "debug_mode",
                "profile_trace", "set_debug"]
ITEM15_METHODS = [("BayesOpt", ["__init__", "tell", "best", "acquisition", "suggest", "run"]),
                  ("KernelSearch", ["__init__", "best_kernel"]),
                  ("LagrangianConstraint", ["__init__", "violation", "penalty", "update"]),
                  ("LagrangianMultiplier", ["__init__", "lagrangian", "minimize"]),
                  ("WGP", ["fit_splits", "th_loglike_masked_fn", "save", "describe", "plot",
                           "plot_space", "plot_hidden", "plot_observations", "plot_datatrace",
                           "widget", "plot_kernel", "plot_concentration", "plot_mapping",
                           "plot_model", "plot_distribution", "plot_distribution2D",
                           "plot_location"]),
                  ("WTP", ["fit_splits", "th_loglike_masked_fn"])]
LMC = ["__init__", "task_correlations", "sampler", "quantiler", "predict_proba",
       "fit_svgp", "predictor", "th_covariance", "th_logpredictive"]

PAIRS = [
    (g3.models.stochastic.StochasticProcess.__init__,
     g3t.models.stochastic.StochasticProcess.__init__),
    (g3.models.elliptical.EllipticalProcess.__init__,
     g3t.models.elliptical.EllipticalProcess.__init__),
    (jsam.ensemble_sampler, tsam.ensemble_sampler),
    (jsam.pt_sampler, tsam.pt_sampler),
    (jsam.mcmc_ensemble, tsam.mcmc_ensemble),
    (jsam.default_beta_ladder, tsam.default_beta_ladder),
    (g3.chains_to_datatrace, g3t.chains_to_datatrace),
    (g3.datatrace_to_chains, g3t.datatrace_to_chains),
    (g3.gelman_rubin, g3t.gelman_rubin),
    (g3.burn_in_samples, g3t.burn_in_samples),
    (g3.effective_sample_min, g3t.effective_sample_min),
    (g3.effective_sample_size, g3t.effective_sample_size),
    (jopt, topt),
    (jnewton, tnewton),
    (jla.safe_cholesky, tla.safe_cholesky),
    (jla.mvn_quad_logdet, tla.mvn_quad_logdet),
    (jdata.data_sunspots, tdata.data_sunspots),
    (jio.transformed_to_natural, tio.transformed_to_natural),
    (jio.natural_to_transformed, tio.natural_to_transformed),
    (g3.models.predictor.Predictor.predict, g3t.models.predictor.Predictor.predict),
    (g3.models.predictor.AveragedPredictor.predict,
     g3t.models.predictor.AveragedPredictor.predict),
    (g3.models.predictor.AveragedPredictor.batch, g3t.models.predictor.AveragedPredictor.batch),
    (g3.models.predictor.Predictor.updated, g3t.models.predictor.Predictor.updated),
    (g3.models.predictor.Predictor.export, g3t.models.predictor.Predictor.export),
    (g3.models.predictor.Predictor.pathwise_sampler,
     g3t.models.predictor.Predictor.pathwise_sampler),
    (g3.models.predictor.load_predictor, g3t.load_predictor),
    (g3.models.predictor.ExportedPredictor.predict, g3t.ExportedPredictor.predict),
    (jrff.spectral_rff, trff.spectral_rff),
    (jrff.se_spectral_rff, trff.se_spectral_rff),
    (jrff.rff_prior_fn, trff.rff_prior_fn),
    (g3.GraphicalModel.fix_vars, g3t.GraphicalModel.fix_vars),
    (g3.GraphicalModel.params_random, g3t.GraphicalModel.params_random),
    (g3.GraphicalModel.params_datatrace, g3t.GraphicalModel.params_datatrace),
    (g3.GraphicalModel.params_serie, g3t.GraphicalModel.params_serie),
    (g3.GraphicalModel.transform_params, g3t.GraphicalModel.transform_params),
    (g3.GraphicalModel.logp_prior_array, g3t.GraphicalModel.logp_prior_array),
    (g3.GraphicalModel.dict_from_sampling_array, g3t.GraphicalModel.dict_from_sampling_array),
    (jsam.hmc_sampler, tsam.hmc_sampler),
    (jnuts.nuts_sampler, g3t.nuts_sampler),
    (jnuts.nuts_warmup, g3t.nuts_warmup),
    (jneutra.fit_flow, g3t.fit_flow),
    (jneutra.flow_forward, g3t.flow_forward),
    (jneutra.flow_inverse, g3t.flow_inverse),
    (jneutra.init_flow, tneutra.init_flow),
    (jneutra.neutra_logp, g3t.neutra_logp),
    (jneutra.neutra_nuts, g3t.neutra_nuts),
    (jadvi.fit_advi, g3t.fit_advi),
    (jadvi.advi_draws, g3t.advi_draws),
    (jlbfgs.lbfgs_maximize, g3t.lbfgs_maximize),
    (jlbfgs.lbfgs_minimize_guarded, tlbfgs.lbfgs_minimize_guarded),
] + [(getattr(g3, name), getattr(g3t, name)) for name in TOOLKIT] + [
    (getattr(jutils, name), getattr(tutils, name)) for name in UTILS] + [
    (jdata.random_obs, tdata.random_obs), (jdata.uniform_obs, tdata.uniform_obs)] + [
    (getattr(g3.GraphicalModel, name), getattr(g3t.GraphicalModel, name))
    for name in ("__init__", "load", "reset", "save")] + [
    (getattr(g3.Experiment, name), getattr(g3t.Experiment, name)) for name in EXPERIMENT] + [
    (getattr(g3.DeepKernel, name), getattr(g3t.DeepKernel, name))
    for name in ("__init__", "features", "cov", "input_sensitivity", "default_hypers")] + [
    (getattr(g3.LMCSVP, name), getattr(g3t.LMCSVP, name)) for name in LMC] + [
    (g3.Mixing.__init__, g3t.Mixing.__init__),
    (g3.MultiGaussianLik.__init__, g3t.MultiGaussianLik.__init__),
    (g3.with_output, g3t.with_output), (g3.stack_outputs, g3t.stack_outputs)] + [(getattr(jit_ops, name), getattr(tit_ops, name)) for name in ITERATIVE_OPS] + [
    (getattr(g3.IterativePredictor, name), getattr(g3t.IterativePredictor, name))
    for name in ITERATIVE_PREDICTOR] + [(getattr(g3.WGP, name), getattr(g3t.WGP, name)) for name in PROCESS_METHODS] + [
    (getattr(g3, cls).__init__, getattr(g3t, cls).__init__)
    for cls in ("WarpingTanh", "ArcsinhLinear", "BoxCoxLinear", "Identity", "SE", "MAT32",
                "MAT52", "RQ", "Bias")] + [
    (getattr(g3, name), getattr(g3t, name)) for name in ITEM15_FUNCS] + [
    (getattr(getattr(g3, cls), name), getattr(getattr(g3t, cls), name))
    for cls, names in ITEM15_METHODS for name in names] + [
    (g3.bayesian.fanout.lbfgs_fanout_sharded, g3t.bayesian.fanout.lbfgs_fanout_sharded)]


def _named(fn):
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _assert_takes(jax_fn, port_fn, label):
    port = {p.name: i for i, p in enumerate(_named(port_fn))}
    for i, p in enumerate(_named(jax_fn)):
        if p.name.startswith("_"):
            continue
        assert p.name in port, f"{label}: the port lacks {p.name!r}"
        if p.kind is p.POSITIONAL_OR_KEYWORD:
            assert port[p.name] == i, (f"{label}: {p.name!r} is positional argument "
                                       f"{port[p.name]} on the port, {i} in the JAX package")


@pytest.mark.parametrize("jax_fn,port_fn", PAIRS, ids=lambda f: getattr(f, "__qualname__", "?"))
def test_signature_takes_jax_arguments(jax_fn, port_fn):
    _assert_takes(jax_fn, port_fn, port_fn.__qualname__)


def _models():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 2)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(16)).astype(np.float32)
    # EllipticalProcess(space, location, kernel, mapping, degree, noisy, var_noise)
    jp = g3.GP(x, g3.Bias(), g3.SE(x), None, None, True, None, name="API_GP")
    tp = g3t.GP(x, g3t.Bias(), g3t.SE(x), None, None, True, None, name="API_GP")
    return jp, tp, x, y


def test_statistic_methods_take_jax_arguments():
    jp, tp, _, _ = _models()
    for name in STATISTICS:
        _assert_takes(getattr(jp, name), getattr(tp, name), name)


def test_calls_in_jax_order_and_keywords():
    jp, tp, x, y = _models()
    for p in (jp, tp):
        # set_space(space, hidden, order, inputs, outputs, index) and
        # observed(inputs, outputs, order, index, hidden), positionally
        p.observed(x, y, None, None, None)
        p.set_space(x[:5], y[:5], None, None, None, None)
        assert p.is_observed and len(p.hidden) == 5 and len(p.order) == 5
        assert len(p.index) == 16 and np.array_equal(np.asarray(p.index), np.arange(16))
    assert tp.name == jp.name == "API_GP"
    params = jp.params_default
    u = jp.active.dict_to_array(params)
    np.testing.assert_allclose(tp.logp(params, None, None, None, False, False),
                               jp.logp(params, None, None, None, False, False), rtol=1e-5)
    np.testing.assert_allclose(tp.dlogp(u, None, None, None, False, True),
                               np.asarray(jp.dlogp(u, None, None, None, False, True)),
                               rtol=1e-4, atol=1e-5)
    pred = tp.predict(params, None, None, None, True, True, False, False, True, False, False,
                      0, False, False, False, None)
    assert set(pred) == set(jp.predict(params, None, None, None, True, True, False, False, True,
                                       False, False, 0, False, False, False, None))
    kw = dict(start=u, samples=3, chains=6, raw=True, parallel=True, threads=4, load=False,
              seed=1, nuts_warmup=10, max_depth=4, target_accept=0.9, nuts_mass="dense",
              nuts_chunk=5, neutra_warmup=10, advi_steps=10, advi_mc=2, advi_lr=0.1,
              advi_full_rank=False)
    chain, lnprob = tp.sample_hypers(**kw)
    assert chain.shape == (6, 3, tp.active.ndim) and np.isfinite(lnprob).all()
    for method in ("nuts", "neutra", "advi"):
        chain, lnprob = tp.sample_hypers(**dict(kw, method=method))
        assert chain.shape == (6, 3, tp.active.ndim) and np.isfinite(lnprob).all(), method
    lnprob, chain = tsam.mcmc_ensemble(tp.active.ndim, 2, 6, None, u, tp._sampling_logps()[0],
                                       None, None, 0.1, 0.01, 4, True, 3)
    assert chain.shape == (6, 2, tp.active.ndim)
    p0 = np.asarray(u)[None, :] * np.ones((4, 1), np.float32)
    chain, _ = tsam.ensemble_sampler(tp._sampling_logps()[0], p0, 2, 7, 2.0, True)
    assert chain.shape == (4, 2, tp.active.ndim)
    pt0 = np.stack([p0, p0])
    loglike, logprior = tp._sampling_logps(tempered=True)[1:]
    chain, _ = tsam.pt_sampler(loglike, logprior, pt0, 2, None, 7, 2.0)
    assert chain.shape == (4, 2, tp.active.ndim)
    with pytest.raises(TypeError):
        tp.find_MAP(display=False, rank=8)  # as the JAX package: scipy takes no solver knobs
    # file= is load-or-create: a new file is written, an existing one loaded
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.g3")
        saved = g3t.GP(x, location=g3t.Bias(), kernel=g3t.SE(x), file=path, name="API_F")
        assert os.path.isfile(path)
        loaded = g3t.GP(x, location=g3t.Bias(), kernel=g3t.SE(x), file=path, name="API_F")
        assert loaded.name == saved.name and loaded.ndim == saved.ndim
    # active=True joins the active registry (creating it when there is none)
    g3t.GraphicalModel.active = None
    try:
        first = g3t.GP(x, location=g3t.Bias(), kernel=g3t.SE(x), active=True, name="API_A")
        second = g3t.GP(x, location=g3t.Bias(), kernel=g3t.SE(x), active=True, name="API_B")
        assert first.active is second.active is g3t.GraphicalModel.active
        assert first.active.name == "GM_API_A"
    finally:
        g3t.GraphicalModel.active = None


FAMILY_METHODS = {
    "TP": ["th_loglike_fn", "th_variance", "th_covariance", "th_logpredictive", "quantiler",
           "sampler", "_quantile_p", "_batch_quantile_p", "_batch_latent_rand", "th_freedom",
           "predict", "predictor", "averaged_predictor", "batch_predict"],
    "WTP": ["th_mean", "th_variance", "th_covariance"],
    "MP": ["th_loglike_fn", "th_lower", "th_upper", "th_freedom", "th_median", "th_mean",
           "th_variance", "th_covariance", "th_logpredictive", "quantiler", "sampler"],
    "TGP": ["th_loglike_fn", "th_transport", "th_transport_diag", "th_transport_inv",
            "mean", "std", "variance", "median", "quantiler", "sampler", "predict"],
    "CGP": ["th_loglike_fn", "th_location", "th_kernel_sd", "quantiler", "sampler", "mean",
            "median", "std", "variance"],
    "CSTP": ["th_loglike_fn"],
}
CLASSES = ["TP", "WTP", "MP", "TGP", "CGP", "CSTP", "TransformedStudentTProcess",
           "StudentTProcess", "WarpedStudentTProcess", "MarginalProcess",
           "TransportGaussianProcess", "CopulaGaussianProcess", "CopulaStudentTProcess",
           "Freedom", "ExpFlat", "FlatPos", "FlatExpId", "Exponential", "UniformPrior",
           "Normal", "StudentT", "Uniform", "ID", "TLocation", "TScale", "TMapping",
           "TKernel", "TTriangular", "TransportComposed"]
TRANSPORT_METHODS = ["__call__", "diag", "inv", "logdet_dinv", "posterior"]


@pytest.mark.parametrize("family", sorted(FAMILY_METHODS))
def test_family_methods_take_jax_arguments(family):
    for name in FAMILY_METHODS[family]:
        _assert_takes(getattr(getattr(g3, family), name), getattr(getattr(g3t, family), name),
                      f"{family}.{name}")


@pytest.mark.parametrize("cls", CLASSES)
def test_family_classes_take_jax_arguments(cls):
    _assert_takes(getattr(g3, cls).__init__, getattr(g3t, cls).__init__, cls)
    if cls.startswith("T") and hasattr(g3t.hypers.transports, cls):
        for name in TRANSPORT_METHODS:
            _assert_takes(getattr(getattr(g3, cls), name), getattr(getattr(g3t, cls), name),
                          f"{cls}.{name}")


def test_degree_and_aliases():
    """``EllipticalProcess(degree=...)`` builds a Student-t process; the
    reference's aliases exist (the JAX package's compat surface), and the
    ones that need machinery not ported yet name their ROADMAP item."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 1)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    ep = g3t.EllipticalProcess(x, g3t.Bias(), g3t.SE(x), None, g3t.Freedom(), True, None,
                               name="API_EP")
    ep.observed(x, y)
    assert "API_EP_Freedom_degree" in ep.active.params_spec
    assert float(ep.freedom(ep.params_default)) == 2.0 + 12 + 12
    assert sorted(g3t.compat.__all__) == sorted(g3.compat.__all__)
    for name in g3.compat.__all__:
        assert callable(getattr(g3t, name)), name
    import torch

    a = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    torch.testing.assert_close(g3t.cholesky_robust(a), torch.linalg.cholesky(a))
    assert float(g3t.tt_to_num(torch.tensor(float("nan")))) == 0.0
    assert float(g3t.inf_to_num(torch.tensor(float("inf")))) == 1e10
    grad = g3t.gradient(lambda v: (v ** 2).sum())(torch.tensor([1.0, 2.0]))
    torch.testing.assert_close(grad, torch.tensor([2.0, 4.0]))
    fn = g3t.makefn(lambda v: v + 1)
    assert fn(1) == 2 and fn.executed == 1
    assert g3t.transformed_hypers({"GP_SE_var": 1.0}) == g3.transformed_hypers(
        {"GP_SE_var": 1.0})
    assert g3t.modelcontext(ep.active) is ep.active
    # without a model: the active registry, the last one made or activated
    assert g3t.modelcontext() is g3t.GraphicalModel.active is ep.active
    g3t.GraphicalModel.active = None
    assert g3t.modelcontext() is None
    # debug_p prints only under the debug switch
    g3t.debug_p("silent")
    g3t.set_debug(True)
    try:
        g3t.debug_p("trace")
    finally:
        g3t.set_debug(False)


CATALOGUE_CLASSES = [
    "One", "Delta", "DeltaEq", "DeltaEq2", "Minimum", "Difference", "L1", "L2", "ARD", "ARD_L1",
    "ARD_L2", "ARD_Dot", "ARD_DotBias", "PSD", "PSD_Dot", "PSD_L2",
    "KernelDot", "KernelStationary", "KernelSum", "KernelProd", "KernelScale", "KernelShift",
    "KernelMax", "KernelEquals", "KernelEquals2", "KernelNoise", "BW", "VAR", "NIL", "LIN", "POL",
    "NN", "WN", "OU", "KernelPeriodic", "COS", "SIN", "SINC", "SM",
    "BlackBox", "Linear", "Power", "Zero",
    "LinearMapping", "LogShifted", "BoxCoxShifted", "BoxCoxLinear2", "WarpingBoxCox",
    "SinhArcsinh", "Logistic", "MappingComposed", "GraphicalModel"]
CATALOGUE_MODULES = [("hypers.metrics", "Metric"), ("hypers.kernels", "Kernel"),
                     ("hypers.means", "Mean"), ("hypers.mappings", "Mapping")]
CATALOGUE_METHODS = {
    "Kernel": ["cov", "input_sensitivity", "default_hypers", "check_hypers"],
    "Metric": ["gram", "input_sensitivity"], "DeltaEq": ["gram"], "DeltaEq2": ["gram"],
    "Mean": ["__call__", "eval"], "Mapping": ["inv", "forward", "logdet_dinv", "__call__"],
    "GraphicalModel": ["activate", "register_param", "dict_to_array"],
}


@pytest.mark.parametrize("cls", CATALOGUE_CLASSES)
def test_catalogue_classes_take_jax_arguments(cls):
    """Every class of the catalogue exists at the port's top level under
    the JAX package's name, with its constructor's arguments."""
    _assert_takes(getattr(g3, cls).__init__, getattr(g3t, cls).__init__, cls)
    for name in CATALOGUE_METHODS.get(cls, []):
        _assert_takes(getattr(getattr(g3, cls), name), getattr(getattr(g3t, cls), name),
                      f"{cls}.{name}")


@pytest.mark.parametrize("module,base", CATALOGUE_MODULES)
def test_catalogue_modules_export_jax_names(module, base):
    """Each catalogue module of the port exports every name the JAX
    package's does, each taking the same arguments."""
    import importlib

    jmod = importlib.import_module("g3py_tpu." + module)
    tmod = importlib.import_module("g3py_tpu_torch." + module)
    assert set(jmod.__all__) <= set(tmod.__all__), set(jmod.__all__) - set(tmod.__all__)
    for name in jmod.__all__:
        _assert_takes(getattr(jmod, name).__init__, getattr(tmod, name).__init__, name)
    for name in CATALOGUE_METHODS[base]:
        _assert_takes(getattr(getattr(jmod, base), name), getattr(getattr(tmod, base), name),
                      f"{base}.{name}")


def test_catalogue_functions_and_settings():
    from g3py_tpu.ops import gram as jgram
    from g3py_tpu_torch.ops import gram as tgram

    for fn in ("weighted_dot", "pairwise_prod", "pairwise_sum", "_pairwise_reduce"):
        _assert_takes(getattr(jgram, fn), getattr(tgram, fn), fn)
    for fn in ("get_model", "modelcontext"):
        _assert_takes(getattr(g3, fn), getattr(g3t, fn), fn)
    assert set(g3.hypers.__all__) <= set(g3t.hypers.__all__)
    assert g3t.settings.strict_dtypes is False
    g3t.settings.strict_dtypes = True
    try:
        with pytest.raises(TypeError, match="strict_dtypes"):
            g3t.config.asarray_x(np.zeros(2, np.float64))
        assert g3t.config.asarray_x(np.zeros(2, np.float32)).dtype == np.float32
    finally:
        g3t.settings.strict_dtypes = False
    assert g3t.config.asarray_x(np.zeros(2, np.float64)).dtype == np.dtype(g3t.settings.floatx)


def test_lazy_names_star_import_and_a_failed_load():
    """A load that fails raises its own error again at the next use (not an
    AttributeError from a half-loaded package), and once the failure is
    gone the lazily loaded names come with ``from g3py_tpu_torch import *``."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['g3py_tpu_torch.compat'] = None\n"
        "import g3py_tpu_torch as g3t\n"
        "for _ in range(2):\n"
        "    try:\n"
        "        g3t.GP\n"
        "    except ImportError:\n"
        "        pass\n"
        "    else:\n"
        "        raise AssertionError('a failed load was hidden')\n"
        "del sys.modules['g3py_tpu_torch.compat']\n"
        "ns = {}\n"
        "exec('from g3py_tpu_torch import *', ns)\n"
        "assert all(k in ns for k in ('GP', 'SE', 'Predictor', 'load_predictor', 'settings'))\n"
        "print('ok')\n")
    root = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env={"PYTHONPATH": root, "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


LIKELIHOODS = ["Likelihood", "GaussianLik", "StudentTLik", "BernoulliLik", "PoissonLik",
               "NegBinomialLik", "OrdinalLik", "CategoricalLik", "HeteroscedasticLik"]
LIKELIHOOD_METHODS = ["logp_elem", "cond_mean", "cond_var", "expected_logp",
                      "predictive_moments", "noise_var", "check_targets", "latent_guess",
                      "default_hypers", "check_hypers"]
SPARSE_METHODS = {
    "SGP": ["__init__", "observed", "th_loglike_fn", "th_loglike_masked_fn", "fit_svgp",
            "predictor", "posterior_state", "predict", "sample_hypers", "find_MAP"],
    "SWGP": ["__init__", "fit_svgp", "th_mean", "th_variance"],
    "SVP": ["__init__", "observed", "th_loglike_fn", "th_location", "th_kernel_diag", "th_mean",
            "th_median", "th_variance", "th_covariance", "th_logpredictive", "posterior_state",
            "predictor", "predict_proba", "predict_class", "sampler", "quantiler", "fit_svgp"],
    "MulticlassSVP": ["__init__", "th_mean", "th_variance", "th_covariance",
                      "th_logpredictive", "predict_proba", "predict_class", "sampler",
                      "quantiler", "scores", "fit_svgp"],
    "HeteroscedasticSVP": ["__init__", "th_mean", "th_variance", "th_covariance",
                           "th_logpredictive", "noise_field", "sampler", "quantiler"],
    "InducingPoints": ["__init__", "check_hypers", "default_hypers", "value", "resolve"],
    "VariationalQ": ["__init__", "factors", "kl"],
    "VariationalQHeads": ["__init__", "factors", "kl"],
}


def test_sparse_names_exposed():
    """The JAX package's sparse-family names (and aliases) on the port's top
    level, the aliases the same classes."""
    for name in LIKELIHOODS + list(SPARSE_METHODS) + [
            "SparseGaussianProcess", "SparseWarpedGaussianProcess", "SparseVariationalProcess",
            "select_inducing"]:
        assert hasattr(g3, name) and hasattr(g3t, name), name
    assert g3t.SGP is g3t.SparseGaussianProcess and g3t.SWGP is g3t.SparseWarpedGaussianProcess
    assert g3t.SVP is g3t.SparseVariationalProcess
    assert g3t.models.SGP is g3t.SGP and g3t.models.SVP is g3t.SVP


@pytest.mark.parametrize("cls", sorted(SPARSE_METHODS))
def test_sparse_classes_take_jax_arguments(cls):
    for name in SPARSE_METHODS[cls]:
        _assert_takes(getattr(getattr(g3, cls), name), getattr(getattr(g3t, cls), name),
                      f"{cls}.{name}")


@pytest.mark.parametrize("cls", LIKELIHOODS)
def test_likelihoods_take_jax_arguments(cls):
    for name in ["__init__"] + LIKELIHOOD_METHODS:
        _assert_takes(getattr(getattr(g3, cls), name), getattr(getattr(g3t, cls), name),
                      f"{cls}.{name}")
    for name in ("probs", "log_predictive", "noise_mean", "_grid", "_split", "_cuts"):
        if hasattr(getattr(g3, cls), name):
            _assert_takes(getattr(getattr(g3, cls), name), getattr(getattr(g3t, cls), name),
                          f"{cls}.{name}")


def test_sparse_functions_take_jax_arguments():
    from g3py_tpu.models import likelihoods as jlik, sparse as jsp
    from g3py_tpu_torch.models import likelihoods as tlik, sparse as tsp

    for jf, tf in ((jsp.select_inducing, tsp.select_inducing),
                   (jsp.make_inducing, tsp.make_inducing),
                   (jsp.signal_kernel_diag, tsp.signal_kernel_diag),
                   (jlik.sample_conditional, tlik.sample_conditional)):
        _assert_takes(jf, tf, tf.__qualname__)
    # the data-parallel trainers name their ROADMAP item (16)
    for fn, args in ((tsp._sharded_data_layout, (2, None, None)),
                     (tsp._sharded_draw_factory, (4, 2, True))):
        with pytest.raises(NotImplementedError, match="item 16"):
            fn(*args)


STATE_SPACE_METHODS = {
    "StateSpaceGP": ["__init__", "observed", "th_loglike_fn", "nll_distributed", "th_location",
                     "th_kernel_diag", "th_mean", "th_median", "th_variance", "th_covariance",
                     "th_logpredictive", "posterior_state", "predictor", "_joint_draws",
                     "sampler", "quantiler", "_run_smoother", "_prior_diag"],
    "MultiStateSpaceGP": ["__init__", "observed", "th_loglike_fn", "nll_distributed",
                          "th_variance", "th_logpredictive", "_joint_draws", "sampler",
                          "quantiler", "task_correlations", "_run_smoother", "_h_rows"],
    "SpatioTemporalSSGP": ["__init__", "field", "task_correlations", "_interp",
                           "_run_smoother_weights"],
    "SparseSpatioTemporalSSGP": ["__init__", "observed", "th_loglike_fn", "nll_distributed",
                                 "_joint_draws", "sampler", "quantiler", "_vrows", "_rows_fn",
                                 "_run_smoother", "_run_smoother_weights"],
    "SpatialMixing": ["__init__", "check_hypers", "default_hypers", "spatial_cov", "values"],
}
SSM_OPS = ["ssm_leaves", "ssm_blocks", "ssm_blocks_multi", "parallel_kalman_nll",
           "parallel_kalman_filter", "parallel_kalman_quad_logdet", "parallel_smoother",
           "chunked_kalman_nll", "chunked_smoother_diag", "periodic_coefficients", "small_inv",
           "small_chol", "ssm_prior_state_sample"]


def test_state_space_names_exposed():
    """The JAX package's state-space names (and aliases) on the port's top
    level, the non-gaussian (Laplace) family's among them; the settings."""
    for name in ("StateSpaceGP", "SSGP", "MultiStateSpaceGP", "LMCSSGP", "SpatioTemporalSSGP",
                 "STSSGP", "SparseSpatioTemporalSSGP", "NonGaussianSSGP", "NGSSGP",
                 "NonGaussianMultiSSGP", "NGMSSGP", "NonGaussianSTSSGP", "NGSTSSGP"):
        assert hasattr(g3, name) and hasattr(g3t, name), name
    assert g3t.SSGP is g3t.StateSpaceGP and g3t.STSSGP is g3t.SpatioTemporalSSGP
    assert g3t.NGSSGP is g3t.NonGaussianSSGP and g3t.NGSTSSGP is g3t.NonGaussianSTSSGP
    assert isinstance(g3t.NGSSGP(space=np.zeros((4, 1)), kernel=g3t.MAT32(np.zeros((4, 1))),
                                 name="API_NG"), g3t.StateSpaceGP)
    for key in ("ssm_harmonics", "ssm_se_order", "ssm_chunk_threshold", "ssm_chunk",
                "ssm_mxu_state_dim", "ssm_laplace_iters"):
        assert getattr(g3t.settings, key) == getattr(g3.config.settings, key), key


@pytest.mark.parametrize("cls", sorted(STATE_SPACE_METHODS))
def test_state_space_classes_take_jax_arguments(cls):
    from g3py_tpu.models import spatiotemporal as jst
    from g3py_tpu_torch.models import spatiotemporal as tst

    jcls = getattr(g3, cls, None) or getattr(jst, cls)
    tcls = getattr(g3t, cls, None) or getattr(tst, cls)
    for name in STATE_SPACE_METHODS[cls]:
        _assert_takes(getattr(jcls, name), getattr(tcls, name), f"{cls}.{name}")


def test_state_space_ops_take_jax_arguments():
    from g3py_tpu.ops import ssm as jssm
    from g3py_tpu_torch.ops import ssm as tssm

    for name in SSM_OPS:
        _assert_takes(getattr(jssm, name), getattr(tssm, name), name)


LAPLACE_METHODS = {
    "NonGaussianSSGP": ["__init__", "observed", "default_hypers", "_d12", "_chunked_pieces",
                        "_mode", "th_loglike_fn", "nll_distributed", "_run_smoother", "th_mean",
                        "th_median", "th_variance", "th_logpredictive", "_joint_draws",
                        "sampler", "quantiler"],
    "NonGaussianMultiSSGP": ["__init__", "observed", "default_hypers", "_lik_idx",
                             "_select_rows", "_d12", "_ll_rows", "_mode", "th_loglike_fn",
                             "nll_distributed", "_run_smoother", "th_mean", "th_median",
                             "th_variance", "th_logpredictive", "_joint_draws", "sampler",
                             "quantiler"],
    "NonGaussianSTSSGP": ["__init__", "default_hypers", "field", "task_correlations",
                          "_run_smoother_weights", "field_rate"],
}
GRID_METHODS = {
    "GridGP": ["__init__", "observed", "th_loglike_fn", "nll_distributed", "_eig_state",
               "_posterior_moments", "th_location", "th_kernel_diag", "th_mean", "th_median",
               "th_variance", "th_covariance", "th_logpredictive", "posterior_state",
               "predictor", "_joint_draws", "sampler", "quantiler"],
    "SKIGP": ["__init__", "observed", "_fit_grid", "_taps", "th_loglike_fn", "nll_distributed",
              "_prior_diag", "_alpha", "_posterior_mean", "_posterior_moments", "th_location",
              "posterior_state", "th_covariance", "_joint_draws"],
}
KRON_OPS = ["kron_apply", "kron_eigs", "kron_dinv", "kron_solve_eig", "kron_gp_nll",
            "cross_mean", "cross_var", "cross_cov", "masked_kron_matvec", "masked_kron_nll",
            "masked_cross_solve", "cubic_interp_axis", "ski_wv", "ski_wtv", "ski_dense_w",
            "ski_operator", "ski_prior_diag", "ski_nll", "ski_solve"]


@pytest.mark.parametrize("cls", sorted(LAPLACE_METHODS) + sorted(GRID_METHODS))
def test_laplace_and_grid_classes_take_jax_arguments(cls):
    """The Laplace state-space family (item 13b) and the grid/SKI families
    (item 14): the JAX package's names on the port's top level, each listed
    method taking the JAX package's arguments in its order."""
    assert hasattr(g3t, cls) and hasattr(g3, cls), cls
    for name in LAPLACE_METHODS.get(cls, GRID_METHODS.get(cls)):
        _assert_takes(getattr(getattr(g3, cls), name), getattr(getattr(g3t, cls), name),
                      f"{cls}.{name}")


def test_kron_ops_and_grid_rows_take_jax_arguments():
    from g3py_tpu.ops import kron as jk
    from g3py_tpu_torch.ops import kron as tk

    for name in KRON_OPS:
        _assert_takes(getattr(jk, name), getattr(tk, name), name)
    _assert_takes(g3.grid_rows, g3t.grid_rows, "grid_rows")


PARALLEL_METHODS = [("GP", "nll_distributed"), ("GP", "predictor_distributed"),
                    ("TP", "nll_distributed"), ("WTP", "nll_distributed"),
                    ("GP", "_find_map_distributed"), ("DistributedPredictor", "__init__"),
                    ("DistributedPredictor", "sampler"), ("Experiment", "run_fanout")]


def test_parallel_takes_jax_arguments():
    """Item 16a: the port's ``parallel`` package exports the JAX package's
    ``parallel.__all__``, each name taking its arguments, and the
    band-sharded consumers take theirs."""
    assert g3t.parallel.__all__ == g3.parallel.__all__
    for name in g3.parallel.__all__:
        _assert_takes(getattr(g3.parallel, name), getattr(g3t.parallel, name), name)
    for cls, name in PARALLEL_METHODS:
        _assert_takes(getattr(getattr(g3, cls), name), getattr(getattr(g3t, cls), name),
                      f"{cls}.{name}")
    _assert_takes(g3.fit_splits, g3t.fit_splits, "fit_splits")
