"""Process layer: the stochastic-process base, the elliptical posterior
core, GP/WGP and the serving Predictor."""

from .stochastic import StochasticProcess
from .elliptical import EllipticalProcess
from .gaussian import GaussianProcess, WarpedGaussianProcess
from .predictor import Predictor

GP = GaussianProcess
WGP = WarpedGaussianProcess

__all__ = ["StochasticProcess", "EllipticalProcess", "GaussianProcess",
           "WarpedGaussianProcess", "GP", "WGP", "Predictor"]
