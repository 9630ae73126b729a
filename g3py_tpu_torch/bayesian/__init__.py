"""Bayesian layer: the graphical-model parameter registry, the optimizers
behind ``find_MAP`` (the scipy wrapper and the batched L-BFGS of
``engine='jax'``), the samplers behind ``sample_hypers`` (ensemble,
parallel-tempered, HMC, NUTS, NeuTra, ADVI) and the datatrace
diagnostics."""

from .registry import GraphicalModel, Model, get_model
from .selection import optimize
from .samplers import (ensemble_sampler, pt_sampler, default_beta_ladder, hmc_sampler,
                       mcmc_ensemble)
from .nuts import nuts_sampler, nuts_warmup
from .neutra import fit_flow, flow_forward, flow_inverse, neutra_logp, neutra_nuts
from .advi import fit_advi, advi_draws
from .optimize_jax import lbfgs_maximize
from .average import (chains_to_datatrace, datatrace_to_chains, gelman_rubin,
                      burn_in_samples, effective_sample_min, effective_sample_size)

__all__ = ["GraphicalModel", "Model", "get_model", "optimize", "ensemble_sampler", "pt_sampler",
           "default_beta_ladder", "hmc_sampler", "mcmc_ensemble", "nuts_sampler", "nuts_warmup",
           "fit_flow", "flow_forward", "flow_inverse", "neutra_logp", "neutra_nuts",
           "fit_advi", "advi_draws", "lbfgs_maximize", "chains_to_datatrace",
           "datatrace_to_chains", "gelman_rubin", "burn_in_samples",
           "effective_sample_min", "effective_sample_size"]
