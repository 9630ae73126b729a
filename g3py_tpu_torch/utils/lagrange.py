"""Augmented-Lagrangian constrained optimizer (the port's own copy of
:mod:`g3py_tpu.utils.lagrange`, numpy and scipy on the host).

Minimize f(x) subject to bands a <= g_i(x) <= b through quadratic
penalties with multiplier and penalty updates, an outer loop around
``scipy.optimize.minimize``.  A constraint may be scalar- or vector-valued
(one multiplier a component).  A standalone utility: the process stack does
not use it.
"""

import numpy as np
import scipy.optimize as sp_optimize

__all__ = ["LagrangianConstraint", "LagrangianMultiplier"]


class LagrangianConstraint:
    """One band a <= g(x) <= b with a multiplier a component.  ``g`` may
    return a scalar or a vector; ``lower``/``upper`` broadcast against it."""

    def __init__(self, g, lower=None, upper=None, mu=1.0, lam=0.0):
        self.g = g
        self.lower = None if lower is None else np.asarray(lower, np.float64)
        self.upper = None if upper is None else np.asarray(upper, np.float64)
        self.mu = float(mu)      # penalty weight
        self._lam0 = float(lam)
        self.lam_lower = None    # sized at the first evaluation
        self.lam_upper = None

    def _eval(self, x):
        v = np.asarray(self.g(x), dtype=np.float64).ravel()
        if self.lam_lower is None:
            self.lam_lower = np.full_like(v, self._lam0)
            self.lam_upper = np.full_like(v, self._lam0)
        return v

    def violation(self, x):
        """The largest violation of the band at x (0 inside it)."""
        v = self._eval(x)
        viol = np.zeros_like(v)
        if self.lower is not None:
            viol = np.maximum(viol, self.lower - v)
        if self.upper is not None:
            viol = np.maximum(viol, v - self.upper)
        return float(viol.max()) if viol.size else 0.0

    def penalty(self, x):
        """The augmented-Lagrangian penalty term of this constraint."""
        v = self._eval(x)
        total = 0.0
        if self.lower is not None:
            term = np.maximum(0.0, self.lam_lower + self.mu * (self.lower - v))
            total += float(np.sum(term**2 - self.lam_lower**2)) / (2 * self.mu)
        if self.upper is not None:
            term = np.maximum(0.0, self.lam_upper + self.mu * (v - self.upper))
            total += float(np.sum(term**2 - self.lam_upper**2)) / (2 * self.mu)
        return total

    def update(self, x, grow=10.0, tol_improve=0.25, last_violation=None):
        """The multiplier update, and the penalty's growth when the
        violation did not fall below ``tol_improve`` of the last one."""
        v = self._eval(x)
        if self.lower is not None:
            self.lam_lower = np.maximum(0.0, self.lam_lower + self.mu * (self.lower - v))
        if self.upper is not None:
            self.lam_upper = np.maximum(0.0, self.lam_upper + self.mu * (v - self.upper))
        viol = self.violation(x)
        if last_violation is not None and viol > tol_improve * last_violation:
            self.mu *= grow
        return viol


class LagrangianMultiplier:
    """The outer augmented-Lagrangian loop."""

    def __init__(self, f, constraints=(), jac=None):
        self.f = f
        self.constraints = list(constraints)
        self.jac = jac

    def lagrangian(self, x):
        total = float(np.asarray(self.f(x)).ravel()[0])
        for c in self.constraints:
            total += c.penalty(x)
        return total

    def minimize(self, x0, outer_iters=20, tol=1e-6, method="L-BFGS-B", bounds=None,
                 disp=False, **kwargs):
        """Up to ``outer_iters`` inner minimizations of the Lagrangian, each
        followed by the constraints' updates; stops once every violation is
        below ``tol``.  Returns the last scipy result."""
        x = np.asarray(x0, dtype=np.float64)
        last_violations = [None] * len(self.constraints)
        result = None
        for it in range(outer_iters):
            result = sp_optimize.minimize(self.lagrangian, x, jac=self.jac, method=method,
                                          bounds=bounds, **kwargs)
            x = result.x
            violations = [c.update(x, last_violation=last_violations[i])
                          for i, c in enumerate(self.constraints)]
            last_violations = violations
            max_v = max(violations) if violations else 0.0
            if disp:
                print(f"outer {it}: f={self.f(x):.6g} max_violation={max_v:.3g}")
            if max_v < tol:
                break
        return result
