"""Bayesian layer: the graphical-model parameter registry, the optimizers
behind ``find_MAP`` (the scipy wrapper and the batched L-BFGS of
``engine='jax'``), the samplers behind ``sample_hypers`` (ensemble,
parallel-tempered, HMC, NUTS, NeuTra, ADVI), the datatrace toolkit, the
``Experiment`` model-selection harness with its fused split-training grid
(``fit_splits``), Bayesian optimization (``BayesOpt``) and compositional
kernel structure search (``search_kernel``)."""

from .registry import GraphicalModel, Model, get_model
from .selection import optimize, Experiment
from .samplers import (ensemble_sampler, pt_sampler, default_beta_ladder, hmc_sampler,
                       mcmc_ensemble)
from .nuts import nuts_sampler, nuts_warmup
from .neutra import fit_flow, flow_forward, flow_inverse, neutra_logp, neutra_nuts
from .advi import fit_advi, advi_draws
from .optimize_jax import lbfgs_maximize
from .fanout import lbfgs_fanout, lbfgs_fanout_sharded, fit_splits
from .bo import BayesOpt
from .structure import search_kernel, KernelSearch
from .average import (chains_to_datatrace, datatrace_to_chains, datatrace_to_kde,
                      kde_to_datatrace, cluster_datatrace, errors_datatrace,
                      marginal_datatrace, conditional_datatrace, marginal, conditional,
                      find_candidates, gelman_rubin, burn_in_samples, effective_sample_min,
                      effective_sample_size, plot_datatrace, plot_clusters, kde_datatrace,
                      hist_datatrace, scatter_datatrace)

__all__ = ["GraphicalModel", "Model", "get_model", "optimize", "ensemble_sampler", "pt_sampler",
           "default_beta_ladder", "hmc_sampler", "mcmc_ensemble", "nuts_sampler", "nuts_warmup",
           "fit_flow", "flow_forward", "flow_inverse", "neutra_logp", "neutra_nuts",
           "fit_advi", "advi_draws", "lbfgs_maximize", "lbfgs_fanout", "lbfgs_fanout_sharded",
           "fit_splits", "BayesOpt", "search_kernel", "KernelSearch", "Experiment", "chains_to_datatrace",
           "datatrace_to_chains", "datatrace_to_kde", "kde_to_datatrace", "cluster_datatrace",
           "errors_datatrace", "marginal_datatrace", "conditional_datatrace", "marginal",
           "conditional", "find_candidates", "gelman_rubin", "burn_in_samples",
           "effective_sample_min", "effective_sample_size", "plot_datatrace", "plot_clusters",
           "kde_datatrace", "hist_datatrace", "scatter_datatrace"]
