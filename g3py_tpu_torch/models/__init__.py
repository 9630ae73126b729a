"""Process layer: the stochastic-process base, the elliptical posterior
core, GP/WGP, the serving Predictor and the datatrace-averaged
AveragedPredictor."""

from .stochastic import StochasticProcess
from .elliptical import EllipticalProcess
from .gaussian import GaussianProcess, WarpedGaussianProcess
from .predictor import Predictor, AveragedPredictor

GP = GaussianProcess
WGP = WarpedGaussianProcess

__all__ = ["StochasticProcess", "EllipticalProcess", "GaussianProcess",
           "WarpedGaussianProcess", "GP", "WGP", "Predictor", "AveragedPredictor"]
