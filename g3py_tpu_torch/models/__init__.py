"""Process layer: the stochastic-process base, the elliptical posterior
core, GP/WGP and the Student-t TP/WTP, the marginal (MP), transport (TGP)
and copula (CGP/CSTP) families, the serving Predictor and the
datatrace-averaged AveragedPredictor, the matrix-free
IterativePredictor, and the sparse families: the SGPR collapsed bound
(SGP/SWGP), the sparse variational processes (SVP, MulticlassSVP,
HeteroscedasticSVP) over the observation likelihoods and the linear model
of coregionalization over them (LMCSVP), and the state-space families: the
exact O(n) Markovian GP (StateSpaceGP), its LMC-mixed multi-output form
(MultiStateSpaceGP), the separable spatio-temporal GPs
(SpatioTemporalSSGP, SparseSpatioTemporalSSGP) and their Laplace
counterparts for non-gaussian observations (NonGaussianSSGP,
NonGaussianMultiSSGP, NonGaussianSTSSGP), and the Kronecker grid and SKI
families (GridGP, SKIGP)."""

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
from .predictor import Predictor, AveragedPredictor, IterativePredictor, DistributedPredictor
from .likelihoods import (Likelihood, GaussianLik, StudentTLik, BernoulliLik, PoissonLik,
                          NegBinomialLik, OrdinalLik, CategoricalLik, HeteroscedasticLik,
                          sample_conditional)
from .sparse import (InducingPoints, SparseGaussianProcess, SparseWarpedGaussianProcess,
                     select_inducing)
from .svgp import (VariationalQ, VariationalQHeads, SparseVariationalProcess, MulticlassSVP,
                   HeteroscedasticSVP)
from .lmc import Mixing, MultiGaussianLik, LMCSVP, with_output, stack_outputs
from .statespace import StateSpaceGP, SSGP, MultiStateSpaceGP, LMCSSGP
from .ngssm import (NonGaussianSSGP, NGSSGP, NonGaussianMultiSSGP, NGMSSGP, NonGaussianSTSSGP,
                    NGSTSSGP)
from .spatiotemporal import (SpatioTemporalSSGP, STSSGP, SpatialMixing,
                             SparseSpatioTemporalSSGP)
from .grid import GridGP, grid_rows
from .ski import SKIGP

GP = GaussianProcess
WGP = WarpedGaussianProcess
TP = StudentTProcess
WTP = WarpedStudentTProcess
MP = MarginalProcess
TGP = TransportGaussianProcess
CGP = CopulaGaussianProcess
CSTP = CopulaStudentTProcess
SGP = SparseGaussianProcess
SWGP = SparseWarpedGaussianProcess
SVP = SparseVariationalProcess

__all__ = ["StochasticProcess", "EllipticalProcess", "GaussianProcess",
           "WarpedGaussianProcess", "warped_gaussian_logp_cho", "WarpedGaussianDistribution",
           "StudentTProcess",
           "WarpedStudentTProcess", "WarpedStudentTDistribution", "warped_studentt_logp_cho",
           "MarginalProcess", "Density", "SymmetricDensity", "Uniform", "Normal", "StudentT",
           "TransportProcess", "TransportGaussianProcess", "TransportGaussianDistribution",
           "transport_gaussian_logp_t", "CopulaProcess", "CopulaGaussianProcess",
           "CopulaStudentTProcess", "TransformedStudentTProcess", "Predictor",
           "AveragedPredictor", "IterativePredictor", "DistributedPredictor", "Likelihood",
           "GaussianLik",
           "StudentTLik", "BernoulliLik", "PoissonLik", "NegBinomialLik", "OrdinalLik",
           "CategoricalLik", "HeteroscedasticLik", "sample_conditional", "InducingPoints",
           "SparseGaussianProcess", "SparseWarpedGaussianProcess", "select_inducing",
           "VariationalQ", "VariationalQHeads", "SparseVariationalProcess", "MulticlassSVP",
           "HeteroscedasticSVP", "GP", "WGP", "TP", "WTP", "MP", "TGP", "CGP", "CSTP", "SGP",
           "SWGP", "SVP", "Mixing", "MultiGaussianLik", "LMCSVP", "with_output",
           "stack_outputs", "StateSpaceGP", "SSGP", "MultiStateSpaceGP", "LMCSSGP",
           "SpatioTemporalSSGP", "STSSGP", "SpatialMixing", "SparseSpatioTemporalSSGP",
           "NonGaussianSSGP", "NGSSGP", "NonGaussianMultiSSGP", "NGMSSGP", "NonGaussianSTSSGP",
           "NGSTSSGP", "GridGP", "grid_rows", "SKIGP"]
