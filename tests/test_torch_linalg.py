"""Port parity: robust linear algebra, guards and quadrature (forward)."""

import numpy as np
import pytest
import torch

from g3py_tpu.ops import linalg as jla, guards as jguards, quadrature as jquad
from g3py_tpu_torch.ops import linalg as tla, guards as tguards, quadrature as tquad

from torch_parity import check, floatx

NAMES = ["float32", "float64"]


def _spd(seed, n=12):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n))
    return b @ b.T / n + 0.5 * np.eye(n), rng.standard_normal(n)


def _needs_jitter(seed, n=10):
    """Symmetric with smallest eigenvalue -5e-4 * mean(diag): the clean
    factorization fails and the 4th jitter level (1e-3 * mean(diag)) wins."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.linspace(1.0, 2.0, n)
    eig[0] = -5e-4 * eig.mean()
    return (q * eig) @ q.T


@pytest.mark.parametrize("name", NAMES)
def test_safe_cholesky_pd(name):
    a, _ = _spd(0)
    check(jla.safe_cholesky, tla.safe_cholesky, a, name=name)


@pytest.mark.parametrize("name", NAMES)
def test_safe_cholesky_needs_jitter(name):
    a = _needs_jitter(1)
    assert torch.linalg.cholesky_ex(torch.as_tensor(a))[1] > 0  # clean attempt fails
    _, chol = check(jla.safe_cholesky, tla.safe_cholesky, a, name=name)
    jitter = 1e-3 * np.trace(a) / len(a)
    np.testing.assert_allclose(chol @ chol.T, a + jitter * np.eye(len(a)), atol=1e-4)


def test_safe_cholesky_nonpositive_diagonal():
    a = np.diag([1.0, 2.0, 0.0, 3.0])
    check(jla.safe_cholesky, tla.safe_cholesky, a)


@pytest.mark.parametrize("bad", ["nan", "negative"])
def test_safe_cholesky_total_failure(bad):
    a = np.full((5, 5), np.nan) if bad == "nan" else -np.eye(5)
    want, got = check(jla.safe_cholesky, tla.safe_cholesky, a)
    np.testing.assert_array_equal(got, 1e-10 * np.eye(5, dtype=np.float32))
    quad, logdet, ok = tla.mvn_quad_logdet(torch.as_tensor(a, dtype=torch.float32),
                                           torch.ones(5))
    assert float(ok) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_mvn_quad_logdet_forward(name):
    a, r = _spd(2)
    check(jla.mvn_quad_logdet, tla.mvn_quad_logdet, a, r, name=name)
    check(jla.mvn_quad_logdet, tla.mvn_quad_logdet, _needs_jitter(3), r[:10], name=name)


def test_triangular_helpers():
    a, r = _spd(4)
    chol = np.linalg.cholesky(a)
    rhs = np.stack([r, 2 * r], axis=1)
    for b in (r, rhs):
        check(jla.solve_lower_triangular, tla.solve_lower_triangular, chol, b)
        check(jla.cho_solve, tla.cho_solve, chol, b)
    check(jla.log_det_from_chol, tla.log_det_from_chol, chol)


def test_guards():
    x = np.array([[1.0, np.nan, 2.0], [np.inf, -1.0, -np.inf], [0.5, 0.1, 0.3]])
    check(jguards.to_num, tguards.to_num, x)
    check(jguards.to_cov, tguards.to_cov, x)
    check(jguards.to_cov, tguards.to_cov, np.eye(3) * 2.0)
    check(lambda v: jguards.to_bounded(v, 0.0), lambda v: tguards.to_bounded(v, 0.0),
          np.nan_to_num(x, posinf=1e10, neginf=-1e10))


@pytest.mark.parametrize("name", NAMES)
def test_gauss_hermite(name):
    rng = np.random.default_rng(5)
    mu, sd = rng.standard_normal(7), rng.uniform(0.1, 1.0, 7)
    check(lambda m, s: jquad.gauss_hermite(lambda v: v ** 2 + v, m, s, n=10),
          lambda m, s: tquad.gauss_hermite(lambda v: v ** 2 + v, m, s, n=10),
          mu, sd, name=name)
    with floatx(name):
        a, w = tquad.hermgauss(6, dtype=getattr(torch, name))
        ja, jw = jquad.hermgauss(6, dtype=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw))
