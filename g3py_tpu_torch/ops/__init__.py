"""Numeric ops: guards, quadrature, grams, the port's two CUDA kernels (the
fused stationary gram and the blocked panel Cholesky), robust linear
algebra, the matrix-free (CG/SLQ) inference of large training sets
(:mod:`~g3py_tpu_torch.ops.iterative`) and the special functions of the
Student-t and copula families (:mod:`~g3py_tpu_torch.ops.special`)."""

from .guards import to_num, inf_to_num, to_cov, to_bounded
from .quadrature import gauss_hermite, hermgauss
from .gram import weighted_sqdist, sqdist, weighted_dot, pairwise_sum, pairwise_prod
from .stationary_gram import stationary_gram
from .panel_cholesky import panel_cholesky
from .root import newton_inverse
from .linalg import (safe_cholesky, safe_cholesky_panels, trtri_from_panels,
                     solve_lower_triangular, solve_upper_triangular, cho_solve,
                     log_det_from_chol, mvn_quad_logdet, mvn_loo)
from .iterative import (cg_solve, slq_logdet, lazy_kernel_matvec, iterative_gp_nll,
                        pivoted_cholesky, woodbury_preconditioner, pcg_solve,
                        preconditioned_gp_nll)

__all__ = ["to_num", "inf_to_num", "to_cov", "to_bounded", "gauss_hermite", "hermgauss",
           "weighted_sqdist", "sqdist", "weighted_dot", "pairwise_sum", "pairwise_prod",
           "stationary_gram",
           "panel_cholesky", "newton_inverse", "safe_cholesky", "safe_cholesky_panels",
           "trtri_from_panels", "solve_lower_triangular", "solve_upper_triangular",
           "cho_solve", "log_det_from_chol", "mvn_quad_logdet", "mvn_loo", "cg_solve",
           "slq_logdet", "lazy_kernel_matvec", "iterative_gp_nll", "pivoted_cholesky",
           "woodbury_preconditioner", "pcg_solve", "preconditioned_gp_nll"]
