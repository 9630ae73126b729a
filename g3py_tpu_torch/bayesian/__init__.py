"""Bayesian layer: the graphical-model parameter registry."""

from .registry import GraphicalModel

__all__ = ["GraphicalModel"]
