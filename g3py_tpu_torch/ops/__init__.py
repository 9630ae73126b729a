"""Numeric ops: guards, quadrature, grams, the fused stationary-gram kernel
and robust linear algebra."""

from .guards import to_num, to_cov, to_bounded
from .quadrature import gauss_hermite, hermgauss
from .gram import weighted_sqdist, sqdist, pairwise_sum
from .stationary_gram import stationary_gram
from .linalg import (safe_cholesky, solve_lower_triangular, cho_solve,
                     log_det_from_chol, mvn_quad_logdet)

__all__ = ["to_num", "to_cov", "to_bounded", "gauss_hermite", "hermgauss",
           "weighted_sqdist", "sqdist", "pairwise_sum", "stationary_gram",
           "safe_cholesky", "solve_lower_triangular", "cho_solve",
           "log_det_from_chol", "mvn_quad_logdet"]
