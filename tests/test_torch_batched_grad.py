"""The batched analytic backward of ``mvn_quad_logdet`` on a (R, n, n) stack:
against the single form row by row and against ``jax.grad`` of the JAX
package's ``vmap``-ed form, with a (R, n) and a shared (n,) residual;
a failed row gets a zero gradient as a failed single matrix does, and the
other rows keep theirs; the batched ``_kinv_from_linv`` against the
single one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g3py_tpu.ops import linalg as jla
from g3py_tpu_torch.ops import linalg as tla

from torch_parity import assert_close, floatx

R, N = 4, 9


def _stack(seed, rows=R, n=N):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, n, n))
    k = a @ np.swapaxes(a, 1, 2) + n * np.eye(n)
    return k, rng.standard_normal((rows, n)), rng.standard_normal(n)


def _torch_grads(k, r, gq, gl):
    kt = torch.tensor(k, requires_grad=True)
    rt = torch.tensor(r, requires_grad=True)
    quad, logdet, ok = tla.mvn_quad_logdet(kt, rt)
    ((gq * quad).sum() + (gl * logdet).sum()).backward()
    return quad, logdet, ok, kt.grad, rt.grad


@pytest.mark.parametrize("name", ["float64", "float32"])
@pytest.mark.parametrize("shared", [False, True])
def test_batched_backward_matches_rows_and_jax(shared, name):
    k, r_rows, r_one = _stack(0)
    r = r_one if shared else r_rows
    gq, gl = np.array([1.0, -0.5, 2.0, 0.3]), np.array([0.7, 1.1, -1.0, 0.2])
    with floatx(name):
        k, r, gq_t, gl_t = (np.asarray(a, name) for a in (k, r, gq, gl))
        quad, logdet, ok, dk, dr = _torch_grads(k, r, torch.as_tensor(gq_t),
                                                torch.as_tensor(gl_t))
        assert torch.all(ok == 1.0)
        # row by row through the single form
        dks, drs = [], []
        for i in range(R):
            ki = torch.tensor(k[i], requires_grad=True)
            ri = torch.tensor(r if shared else r[i], requires_grad=True)
            q, l, _ = tla.mvn_quad_logdet(ki, ri)
            (gq_t[i] * q + gl_t[i] * l).backward()
            dks.append(ki.grad)
            drs.append(ri.grad)
        assert_close(dk, torch.stack(dks), name)
        assert_close(dr, sum(drs) if shared else torch.stack(drs), name)

        # jax.grad of the JAX package's vmapped form
        def total(kk, rr):
            q, l, _ = jax.vmap(jla.mvn_quad_logdet, in_axes=(0, None if shared else 0))(kk, rr)
            return (jnp.asarray(gq_t) * q).sum() + (jnp.asarray(gl_t) * l).sum()

        jdk, jdr = jax.grad(total, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(r))
        q_j, l_j, _ = jax.vmap(jla.mvn_quad_logdet, in_axes=(0, None if shared else 0))(
            jnp.asarray(k), jnp.asarray(r))
        assert_close(quad, q_j, name)
        assert_close(logdet, l_j, name)
        assert_close(dr, jdr, name)
        # JAX's dK is the (non-symmetrized) gradient through its factorization;
        # both are gradients of a function of a symmetric K: compare symmetric parts
        sym = 0.5 * (np.asarray(jdk) + np.swapaxes(np.asarray(jdk), 1, 2))
        assert_close(0.5 * (dk + dk.transpose(1, 2)), sym, name)


def test_failed_row_gets_zero_gradient():
    """Row 2 is negative definite: the robust factorization falls back to
    1e-10 I there (ok = 0), its gradient is 0, and the other rows keep the
    gradients they have on their own."""
    k, r, _ = _stack(1)
    k[2] = -np.eye(N)
    with floatx("float32"):
        k, r = k.astype(np.float32), r.astype(np.float32)
        ones = torch.ones(R, dtype=torch.float32)
        quad, logdet, ok, dk, dr = _torch_grads(k, r, ones, ones)
        assert ok.tolist() == [1.0, 1.0, 0.0, 1.0]
        assert torch.all(dk[2] == 0) and torch.all(dr[2] == 0)
        assert torch.isfinite(dk).all() and torch.isfinite(dr).all()
        _, _, _, dk_ok, dr_ok = _torch_grads(k[[0, 1, 3]], r[[0, 1, 3]], ones[:3], ones[:3])
        assert_close(dk[[0, 1, 3]], dk_ok, "float32")
        assert_close(dr[[0, 1, 3]], dr_ok, "float32")
        # the single form's failure gives the same zero
        kt = torch.tensor(k[2], requires_grad=True)
        q, l, o = tla.mvn_quad_logdet(kt, torch.tensor(r[2]))
        (q + l).backward()
        assert float(o) == 0.0 and torch.all(kt.grad == 0)


def test_batched_kinv_from_linv_blocks():
    """The blocked K^{-1} = L^{-T} L^{-1} over a leading row axis equals the
    single one row by row, to the rounding of batched against single
    products (a block smaller than n exercises the mirror)."""
    k, _, _ = _stack(2, rows=3, n=10)
    linv = torch.linalg.inv(torch.linalg.cholesky(torch.tensor(k)))
    batched = tla._kinv_from_linv(linv, block=4)
    for i in range(3):
        torch.testing.assert_close(batched[i], tla._kinv_from_linv(linv[i], block=4),
                                   rtol=1e-13, atol=1e-15)
        torch.testing.assert_close(batched[i], torch.linalg.inv(torch.tensor(k[i])),
                                   rtol=1e-10, atol=1e-12)
