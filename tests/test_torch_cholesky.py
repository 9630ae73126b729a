"""Port parity: K2 (the blocked panel Cholesky, plain version) against the
JAX package's Pallas kernel in interpret mode and against jnp/torch
Cholesky; ``safe_cholesky`` with its Murray gradient; ``trtri_from_panels``;
``mvn_quad_logdet`` value and analytic cotangents, including failure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g3py_tpu.ops import linalg as jla
from g3py_tpu.ops.pallas_cholesky import pallas_cholesky
from g3py_tpu_torch.ops import linalg as tla
from g3py_tpu_torch.ops.panel_cholesky import _plain_form, panel_cholesky

from torch_parity import F32_TOL, F64_TOL, assert_close, floatx

NAMES = ["float32", "float64"]


def _spd(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(dtype)


def _needs_jitter(seed, n=40):
    """Symmetric, smallest eigenvalue -5e-4 * mean(diag): the clean
    factorization fails and a jitter level clear of the edge wins."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.linspace(1.0, 2.0, n)
    eig[0] = -5e-4 * eig.mean()
    return (q * eig) @ q.T


@pytest.mark.parametrize("n,block", [(256, 128), (128, 64)])
def test_plain_form_matches_pallas_interpret(n, block):
    a = _spd(n, n, np.float32)
    want_l, want_dinv = pallas_cholesky(a, block=block, interpret=True)
    got_l, got_dinv, info = _plain_form(torch.as_tensor(a), block)
    assert int(info) == 0
    assert_close(got_l, np.tril(np.asarray(want_l)))
    assert_close(got_dinv, want_dinv)


@pytest.mark.parametrize("n", [77, 200])
def test_ragged_float64_matches_cholesky(n):
    a = _spd(n + 1, n)
    with floatx("float64"):
        want = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    at = torch.as_tensor(a)
    before = at.clone()
    got, dinv, info = panel_cholesky(at, block=64)
    assert torch.equal(at, before)  # the input is only read
    assert int(info) == 0 and got.shape == (n, n)
    assert_close(got, want, name="float64")
    assert dinv.shape == (-(-n // 64), 64, 64)
    lp = torch.eye(dinv.shape[0] * 64, dtype=at.dtype)
    lp[:n, :n] = got
    for k in range(dinv.shape[0]):
        s = slice(64 * k, 64 * (k + 1))
        np.testing.assert_allclose((dinv[k] @ lp[s, s]).numpy(), np.eye(64), atol=1e-12)


@pytest.mark.parametrize("case", ["negative_pivot", "late_negative_pivot", "nan", "spd"])
def test_info_matches_cholesky_ex(case):
    n = 150
    a = _spd(3, n)
    if case == "negative_pivot":
        a[5, 5] = -1.0
    elif case == "late_negative_pivot":  # in the second panel
        a[140, :] = a[:, 140] = 0.0
        a[140, 140] = -2.0
    elif case == "nan":
        a[20, 3] = a[3, 20] = np.nan
    at = torch.as_tensor(a)
    want = int(torch.linalg.cholesky_ex(at)[1])
    got = int(panel_cholesky(at)[2])
    assert got == want
    assert (got == 0) == (case == "spd")
    if case == "late_negative_pivot":
        assert got == 141


def test_non_cpu_tensor_without_kernel_raises():
    with pytest.raises(ValueError, match="no kernel"):
        panel_cholesky(torch.empty((4, 4), device="meta"))
    with pytest.raises(ValueError, match="square"):
        panel_cholesky(torch.ones(3, 4))


def _chol_grad_pair(a, lbar, name):
    with floatx(name):
        want_l, vjp = jax.vjp(jla.safe_cholesky, jnp.asarray(a, dtype=name))
        (want_g,) = vjp(jnp.asarray(lbar, dtype=name))
        at = torch.tensor(a, dtype=getattr(torch, name), requires_grad=True)
        got_l = tla.safe_cholesky(at)
        got_l.backward(torch.as_tensor(lbar, dtype=at.dtype))
    return (got_l, at.grad), (np.asarray(want_l), np.asarray(want_g))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["spd", "jitter", "hopeless"])
def test_safe_cholesky_value_and_murray_gradient(name, case):
    n = 40
    rng = np.random.default_rng(11)
    a = {"spd": _spd(4, n) / n, "jitter": _needs_jitter(5, n),
         "hopeless": -np.eye(n)}[case]
    lbar = np.tril(rng.standard_normal((n, n)))
    got, want = _chol_grad_pair(a, lbar, name)
    assert_close(got, want, name=name)
    if case == "hopeless":
        np.testing.assert_array_equal(got[0].detach().numpy(),
                                      (1e-10 * np.eye(n)).astype(name))
        np.testing.assert_array_equal(got[1].numpy(), 0.0)


def test_safe_cholesky_constant_input_jitter():
    """A constant (rank-one) gram: the clean try fails, the first jitter
    level wins, in both packages.  (Whether a clean factorization of an
    exactly singular matrix fails is decided by rounding, so this size is
    one where both LAPACK builds fail.)"""
    a = np.full((12, 12), 2.0)
    lbar = np.tril(np.random.default_rng(2).standard_normal((12, 12)))
    got, want = _chol_grad_pair(a, lbar, "float64")
    assert_close(got[0], want[0], name="float64")
    # the gradient of a factor with pivots ~1.4e-3 is ~1e6: compare relative
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-7,
                               atol=1e-7 * np.abs(want[1]).max())


@pytest.mark.parametrize("name", NAMES)
def test_trtri_from_panels_matches_blocked_trtri(name):
    n = 200
    with floatx(name):
        a = torch.as_tensor(_spd(6, n), dtype=getattr(torch, name))
        chol, dinv, _ = _plain_form(a, 64)
        want = jla.blocked_trtri(jnp.asarray(chol.numpy()), block=64)
        got = tla.trtri_from_panels(chol, dinv)
    assert_close(got, want, name=name)


def test_kinv_panel_product():
    linv = torch.as_tensor(np.tril(np.random.default_rng(7).standard_normal((150, 150))))
    assert_close(tla._kinv_from_linv(linv, block=64), linv.T @ linv, name="float64")


def _mvn_pair(k, r, gq, gl, name):
    with floatx(name):
        kj, rj = jnp.asarray(k, dtype=name), jnp.asarray(r, dtype=name)
        want, vjp = jax.vjp(jla.mvn_quad_logdet, kj, rj)
        dk, dr = vjp((jnp.asarray(gq, dtype=name), jnp.asarray(gl, dtype=name),
                      jnp.zeros((), dtype=name)))
        kt = torch.tensor(k, dtype=getattr(torch, name), requires_grad=True)
        rt = torch.tensor(r, dtype=getattr(torch, name), requires_grad=True)
        quad, ld, ok = tla.mvn_quad_logdet(kt, rt)
        (gq * quad + gl * ld).backward()
        value = tla.mvn_quad_logdet(kt.detach(), rt.detach())  # value-only path
    return ((quad, ld, ok), value, kt.grad, rt.grad), (want, want, dk, dr)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["spd", "jitter", "failure"])
def test_mvn_quad_logdet_value_and_cotangents(name, case):
    n = 150  # two panels of the factorization
    rng = np.random.default_rng(8)
    k = {"spd": _spd(9, n) / n, "jitter": _needs_jitter(10, n),
         "failure": np.full((n, n), np.nan)}[case]
    r = rng.standard_normal(n)
    got, want = _mvn_pair(k, r, 0.7, -1.3, name)
    if case == "failure":
        assert float(got[0][2]) == 0.0 and float(got[1][2]) == 0.0
        np.testing.assert_array_equal(got[2].numpy(), 0.0)
        np.testing.assert_array_equal(got[3].numpy(), 0.0)
        return
    tol = dict(F64_TOL) if name == "float64" else dict(F32_TOL)
    if case == "jitter" and name == "float32":
        # K^{-1} of a gram with eigenvalues down to ~1e-3 amplifies f32
        # rounding ~1e3-fold; hold the cotangent relative to its largest entry
        tol = dict(rtol=1e-3, atol=1e-3 * float(np.abs(np.asarray(want[2])).max()))
    for g, w in zip(got[:2], want[:2]):
        assert_close(g, w, name=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **tol)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **tol)
