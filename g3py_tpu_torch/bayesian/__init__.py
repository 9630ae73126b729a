"""Bayesian layer: the graphical-model parameter registry, the optimizer
wrapper behind ``find_MAP``, the ensemble samplers behind ``sample_hypers``
and the datatrace diagnostics."""

from .registry import GraphicalModel, Model, get_model
from .selection import optimize
from .samplers import ensemble_sampler, pt_sampler, default_beta_ladder, mcmc_ensemble
from .average import (chains_to_datatrace, datatrace_to_chains, gelman_rubin,
                      burn_in_samples, effective_sample_min, effective_sample_size)

__all__ = ["GraphicalModel", "Model", "get_model", "optimize", "ensemble_sampler", "pt_sampler",
           "default_beta_ladder", "mcmc_ensemble", "chains_to_datatrace",
           "datatrace_to_chains", "gelman_rubin", "burn_in_samples",
           "effective_sample_min", "effective_sample_size"]
