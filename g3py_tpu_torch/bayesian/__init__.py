"""Bayesian layer: the graphical-model parameter registry and the
optimizer wrapper behind ``find_MAP``."""

from .registry import GraphicalModel
from .selection import optimize

__all__ = ["GraphicalModel", "optimize"]
