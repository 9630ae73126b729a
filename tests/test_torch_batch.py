"""Port parity of the batched (hyperparameter-row) path: K1 and K2's plain
versions over a leading row axis, the per-row jitter of the batched robust
Cholesky, the batched L^{-1}, and ``logp_chain`` of GP and WGP against the
JAX package's ``vmap``-ped one.

K1's batch is checked against a per-row loop and against ``jax.vmap`` of
the JAX package's ``_xla_form``; K2's against a per-row loop.  The kernels
themselves are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.ops.pallas_gram import _xla_form
from g3py_tpu_torch.ops import linalg as tla
from g3py_tpu_torch.ops.panel_cholesky import _plain_form as k2_plain, panel_cholesky
from g3py_tpu_torch.ops.stationary_gram import KINDS, stationary_gram

from torch_parity import assert_close, floatx, tol


def _rows_inputs(seed, rows, m, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)), rng.standard_normal((n, d)),
            rng.uniform(0.3, 1.2, (rows, d)), rng.uniform(0.5, 2.0, rows),
            rng.uniform(0.5, 2.0, rows))


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_gram_matches_rows_and_vmapped_xla_form(kind, name):
    x1, x2, rate, var, alpha = _rows_inputs(3, 4, 9, 7, 3)
    with floatx(name):
        t = [torch.as_tensor(a, dtype=getattr(torch, name)) for a in (x1, x2, rate, var, alpha)]
        extra = t[4] if kind == "rq" else None
        got = stationary_gram(kind, t[0], t[1], t[2], t[3], extra)
        assert got.shape == (4, 9, 7)
        for r in range(4):
            one = stationary_gram(kind, t[0], t[1], t[2][r], t[3][r],
                                  None if extra is None else extra[r])
            assert_close(got[r], one, name=name)
        j = [jax.numpy.asarray(a, dtype=name) for a in (x1, x2, rate, var, alpha)]
        want = jax.vmap(lambda r, v, e: _xla_form(kind, j[0], j[1], r, v, e))(j[2], j[3], j[4])
    assert_close(got, np.asarray(want), name=name)


def _spd(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T / n + np.eye(n)


@pytest.mark.parametrize("n,block", [(40, 64), (150, 64), (130, 128)])
def test_batched_panel_cholesky_plain_form_is_the_row_loop(n, block):
    a = torch.stack([torch.as_tensor(_spd(s, n)) for s in range(3)])
    a[1, 5, :] = a[1, :, 5] = 0.0
    a[1, 5, 5] = -1.0
    l, dinv, info = panel_cholesky(a, block)
    nb = -(-n // block)
    assert l.shape == (3, n, n) and dinv.shape == (3, nb, block, block) and info.shape == (3,)
    assert info.tolist() == [0, 6, 0]
    for r in range(3):
        lr, dr, ir = k2_plain(a[r], block)
        assert int(ir) == int(info[r])
        if r != 1:
            torch.testing.assert_close(l[r], lr, rtol=0, atol=0)
            torch.testing.assert_close(dinv[r], dr, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_batched_safe_cholesky_jitters_only_the_failing_row(name):
    """A singular row gets exactly what the unbatched call gives it (its own
    diagonal fix and escalation); the clean rows keep their clean factor."""
    with floatx(name):
        dt = getattr(torch, name)
        rows = [torch.as_tensor(_spd(s, 30), dtype=dt) for s in range(3)]
        rows[1][5, :] = rows[1][:, 5] = 0.0  # a negative pivot: needs the diagonal fix
        rows[1][5, 5] = -1.0
        stack = torch.stack(rows)
        retries = tla.safe_cholesky_panels.retries
        chol, dinv, failed = tla.safe_cholesky_panels(stack)
        assert tla.safe_cholesky_panels.retries > retries
        assert failed.tolist() == [False, False, False]
        for r in range(3):
            one, one_dinv, one_failed = tla.safe_cholesky_panels(rows[r])
            assert not one_failed
            torch.testing.assert_close(chol[r], one, rtol=0, atol=0)
            torch.testing.assert_close(dinv[r], one_dinv, rtol=0, atol=0)
        clean, _, _ = panel_cholesky(rows[0])
        torch.testing.assert_close(chol[0], clean, rtol=0, atol=0)
        # a hopeless row falls back to 1e-10 I alone
        stack[2] = -torch.eye(30, dtype=dt)
        chol, dinv, failed = tla.safe_cholesky_panels(stack)
        assert failed.tolist() == [False, False, True]
        torch.testing.assert_close(chol[2], 1e-10 * torch.eye(30, dtype=dt))
        torch.testing.assert_close(chol[0], clean, rtol=0, atol=0)
        quad, logdet, ok = tla.mvn_quad_logdet(stack, torch.ones(30, dtype=dt))
        assert ok.tolist() == [1.0, 1.0, 0.0]
        q0, l0, _ = tla.mvn_quad_logdet(rows[0], torch.ones(30, dtype=dt))
        assert_close([quad[0], logdet[0]], [q0, l0], name=name)


def test_batched_trtri_from_panels_is_the_row_loop():
    a = torch.stack([torch.as_tensor(_spd(s, 150)) for s in range(2)])
    chol, dinv, _ = panel_cholesky(a, 64)
    linv = tla.trtri_from_panels(chol, dinv)
    for r in range(2):
        torch.testing.assert_close(linv[r], tla.trtri_from_panels(chol[r], dinv[r]),
                                   rtol=0, atol=0)
    eye = torch.eye(150, dtype=torch.float64).expand(2, -1, -1)
    torch.testing.assert_close(linv @ chol, eye, rtol=0, atol=1e-10)


def _pair(kind, name, n=24, d=2):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    if kind == "gp":
        jp = g3.GP(space=x, location=g3.Bias(), kernel=g3.SE(x), name=name)
        tp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name=name)
    else:
        y = (np.exp(0.3 * y) + 1.0).astype(np.float32)
        jp = g3.WGP(space=x, location=g3.Bias(), kernel=g3.SE(x),
                    mapping=g3.BoxCoxLinear(y), name=name)
        tp = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x),
                     mapping=g3t.BoxCoxLinear(y), name=name)
    jp.observed(x, y)
    tp.observed(x, y)
    return jp, tp


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_logp_chain_matches_jax(kind, name):
    """One batched evaluation of R rows (including one whose gram needs the
    guards) against the JAX package's vmapped logp_chain."""
    with floatx(name):
        jp, tp = _pair(kind, f"LC_{kind.upper()}_{name[-2:]}")
        u0 = jp.active.dict_to_array(jp.params_default)
        rng = np.random.default_rng(1)
        rows = (u0 + 0.4 * rng.standard_normal((6, len(u0)))).astype(name)
        rows[5, 1:4] = -40.0  # an amplitude and rates at exp(-40): the prior wall
        got = tp.logp_chain(rows)
        want = np.asarray(jp.logp_chain(rows))
        assert got.shape == (6,) and got.dtype == np.dtype(name)
        assert_close(got, want, name=name)
        for r in (0, 5):
            np.testing.assert_allclose(got[r], tp.logp(rows[r], array=True), **tol(name))
