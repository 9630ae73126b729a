"""Process layer: the stochastic-process base, the elliptical posterior
core, GP/WGP and the Student-t TP/WTP, the marginal (MP), transport (TGP)
and copula (CGP/CSTP) families, the serving Predictor and the
datatrace-averaged AveragedPredictor, and the matrix-free
IterativePredictor."""

from .stochastic import StochasticProcess
from .elliptical import EllipticalProcess
from .gaussian import (GaussianProcess, WarpedGaussianProcess, warped_gaussian_logp_cho,
                       WarpedGaussianDistribution)
from .studentt import (StudentTProcess, WarpedStudentTProcess, WarpedStudentTDistribution,
                       warped_studentt_logp_cho)
from .marginal import (MarginalProcess, Density, SymmetricDensity, Uniform, Normal,
                       StudentT)
from .transport import (TransportProcess, TransportGaussianProcess,
                        TransportGaussianDistribution, transport_gaussian_logp_t)
from .copula import (CopulaProcess, CopulaGaussianProcess, CopulaStudentTProcess,
                     TransformedStudentTProcess)
from .predictor import Predictor, AveragedPredictor, IterativePredictor

GP = GaussianProcess
WGP = WarpedGaussianProcess
TP = StudentTProcess
WTP = WarpedStudentTProcess
MP = MarginalProcess
TGP = TransportGaussianProcess
CGP = CopulaGaussianProcess
CSTP = CopulaStudentTProcess

__all__ = ["StochasticProcess", "EllipticalProcess", "GaussianProcess",
           "WarpedGaussianProcess", "warped_gaussian_logp_cho", "WarpedGaussianDistribution",
           "StudentTProcess",
           "WarpedStudentTProcess", "WarpedStudentTDistribution", "warped_studentt_logp_cho",
           "MarginalProcess", "Density", "SymmetricDensity", "Uniform", "Normal", "StudentT",
           "TransportProcess", "TransportGaussianProcess", "TransportGaussianDistribution",
           "transport_gaussian_logp_t", "CopulaProcess", "CopulaGaussianProcess",
           "CopulaStudentTProcess", "TransformedStudentTProcess", "Predictor",
           "AveragedPredictor", "IterativePredictor", "GP", "WGP", "TP", "WTP", "MP", "TGP",
           "CGP", "CSTP"]
