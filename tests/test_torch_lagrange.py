"""The port's augmented-Lagrangian optimizer against the JAX package's
copy (numpy and scipy in both): the same constrained problems give the
same iterates, multipliers, penalties and violations."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t


def _problem(lib, vector):
    f = lambda x: (x[0] - 2.0) ** 2 + (x[1] + 1.0) ** 2  # noqa: E731
    if vector:
        c = lib.LagrangianConstraint(lambda x: np.array([x[0] + x[1], x[0] - x[1]]),
                                     lower=[-0.5, 0.0], upper=[0.5, 1.0])
    else:
        c = lib.LagrangianConstraint(lambda x: x[0] ** 2 + x[1] ** 2, upper=1.0, mu=2.0)
    return lib.LagrangianMultiplier(f, [c]), c


@pytest.mark.parametrize("vector", [False, True])
def test_matches_jax(vector):
    (jm, jc), (tm, tc) = _problem(g3, vector), _problem(g3t, vector)
    want = jm.minimize(np.zeros(2), outer_iters=15, tol=1e-7)
    got = tm.minimize(np.zeros(2), outer_iters=15, tol=1e-7)
    np.testing.assert_array_equal(got.x, want.x)
    assert tc.mu == jc.mu
    np.testing.assert_array_equal(tc.lam_upper, jc.lam_upper)
    np.testing.assert_array_equal(tc.lam_lower, jc.lam_lower)
    assert tc.violation(got.x) == jc.violation(want.x) < 1e-4
    assert tm.lagrangian(got.x) == jm.lagrangian(want.x)
    x = np.array([3.0, -2.0])
    assert tc.penalty(x) == jc.penalty(x) and tc.violation(x) == jc.violation(x) > 0
