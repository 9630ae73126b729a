"""Port parity of :mod:`g3py_tpu_torch.ops.iterative` (CG, PCG, SLQ, the
pivoted Cholesky, the Woodbury preconditioner, the lazy gram matvec and the
two matrix-free NLLs with their stochastic-trace backward) against
:mod:`g3py_tpu.ops.iterative`: the JAX package's cases (tests/test_ops.py,
``TestIterativeInference`` and the preconditioned classes), each held to
the JAX function at 1e-10 in float64 (JAX x64) from the same inputs and the
JAX package's probes, injected, and to the dense answer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import g3py_tpu.ops.iterative as J
import g3py_tpu_torch.ops.iterative as T
from g3py_tpu.hypers.kernels import SE as JSE
from g3py_tpu_torch.hypers.kernels import SE as TSE

from torch_parity import KernelSpy, assert_close, floatx


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T / n + np.eye(n), rng


def _jax_probes(seed, probes, n, grad="bernoulli"):
    """The JAX package's (probes, n) draws of a seed: the SLQ Rademacher
    probes and the gradient's (``bernoulli``: PRNGKey(seed + 104729), as
    ``preconditioned_gp_nll``; ``fold_in``: fold_in(PRNGKey(seed), 1), as
    ``iterative_gp_nll``)."""
    key = random.PRNGKey(seed)
    slq = random.rademacher(key, (probes, n), dtype=jnp.float64)
    if grad == "bernoulli":
        g = 2.0 * random.bernoulli(random.PRNGKey(seed + 104729), 0.5, (probes, n)) - 1.0
    else:
        g = random.rademacher(random.fold_in(key, 1), (probes, n), dtype=jnp.float64)
    return {"slq": np.asarray(slq), "grad": np.asarray(g, np.float64)}


def _se(x, prefix):
    out = []
    for cls in (JSE, TSE):
        k = cls(x)
        k.check_dims(x)
        k.check_hypers(prefix)
        out.append(k)
    return out


def test_cg_one_and_several_right_hand_sides():
    with floatx("float64"):
        k, rng = _spd(64, 0)
        b, bs = rng.standard_normal(64), rng.standard_normal((3, 64))
        kj, kt = jnp.asarray(k), torch.as_tensor(k)
        for rhs in (b, bs):
            want = J.cg_solve(lambda v: kj @ v, jnp.asarray(rhs), maxiter=200)
            got = T.cg_solve(lambda v: kt @ v, torch.as_tensor(rhs), maxiter=200)
            assert_close(got, want, "float64")
            np.testing.assert_allclose(got.numpy() @ k.T if rhs.ndim == 2 else k @ got.numpy(),
                                       rhs, atol=1e-5)
        x0 = rng.standard_normal(64)
        want = J.cg_solve(lambda v: kj @ v, jnp.asarray(b), maxiter=200, x0=jnp.asarray(x0))
        got = T.cg_solve(lambda v: kt @ v, torch.as_tensor(b), maxiter=200,
                         x0=torch.as_tensor(x0))
        assert_close(got, want, "float64")


def test_slq_logdet_against_slogdet():
    with floatx("float64"):
        k, _ = _spd(128, 1)
        kj, kt = jnp.asarray(k), torch.as_tensor(k)
        want = J.slq_logdet(lambda v: kj @ v, 128, random.PRNGKey(0), probes=32,
                            lanczos_iters=40)
        zs = _jax_probes(0, 32, 128)["slq"]
        got = T.slq_logdet(lambda v: kt @ v, 128, torch.tensor(zs), probes=32,
                           lanczos_iters=40)
        chunked = T.slq_logdet(lambda v: kt @ v, 128, torch.tensor(zs), probes=32,
                               lanczos_iters=40, probe_chunk=5)
        assert_close(got, want, "float64")
        assert_close(chunked, want, "float64")
        np.testing.assert_allclose(float(got), np.linalg.slogdet(k)[1], rtol=0.05)
        # the port's own draws: a seed and a generator give the same probes
        gen = torch.Generator().manual_seed(4)
        a = T.slq_logdet(lambda v: kt @ v, 128, 4, probes=8, lanczos_iters=20)
        b = T.slq_logdet(lambda v: kt @ v, 128, gen, probes=8, lanczos_iters=20)
        assert float(a) == float(b)


def test_iterative_nll_value_and_gradient():
    with floatx("float64"):
        k, rng = _spd(96, 2)
        y = rng.standard_normal(96)
        kw = dict(probes=32, cg_iters=200, lanczos_iters=40)
        want, gwant = jax.value_and_grad(lambda km, yy: J.iterative_gp_nll(km, yy, **kw),
                                         argnums=(0, 1))(jnp.asarray(k), jnp.asarray(y))
        kt = torch.tensor(k, requires_grad=True)
        yt = torch.tensor(y, requires_grad=True)
        got = T.iterative_gp_nll(kt, yt, seed=_jax_probes(0, 32, 96, grad="fold_in"), **kw)
        got.backward()
        got = got.detach()
        assert_close(got, want, "float64")
        assert_close(kt.grad, gwant[0], "float64")
        assert_close(yt.grad, gwant[1], "float64")
        chol = np.linalg.cholesky(k)
        z = np.linalg.solve(chol, y)
        exact = 0.5 * z @ z + np.log(np.diag(chol)).sum() + 0.5 * 96 * np.log(2 * np.pi)
        np.testing.assert_allclose(float(got), exact, rtol=0.02)
        # the gradient's direction against the exact one
        kinv = np.linalg.inv(k)
        a = kinv @ y
        g_ex = -0.5 * np.outer(a, a) + 0.5 * kinv
        g1, g2 = kt.grad.numpy().ravel(), g_ex.ravel()
        assert g1 @ g2 / np.sqrt((g1 @ g1) * (g2 @ g2)) > 0.9


@pytest.mark.parametrize("block", [32, 100, 2048])
def test_lazy_matvec(block):
    """Ragged (100 = 3 x 32 + 4), exact and single-slab blocks; one K1 call
    a slab."""
    with floatx("float64"):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((100, 3))
        kj, kt = _se(x, "LZ_")
        params = {p.name: p.testval() for p in kj.hypers}
        v = rng.standard_normal((100, 2))
        want = J.lazy_kernel_matvec(kj, {k: jnp.asarray(a) for k, a in params.items()},
                                    jnp.asarray(x), jnp.asarray(v), block=block)
        pt = {k: torch.as_tensor(a) for k, a in params.items()}
        got = T.lazy_kernel_matvec(kt, pt, torch.as_tensor(x), torch.as_tensor(v), block=block)
        assert_close(got, want, "float64")
        dense = kt.cov(pt, torch.as_tensor(x)).numpy() @ v
        np.testing.assert_allclose(got.numpy(), dense, atol=1e-12)


def test_lazy_matvec_calls_the_gram_once_a_slab(monkeypatch):
    spy = KernelSpy(monkeypatch)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((100, 3)), dtype=torch.float32)
    _, kt = _se(x.numpy(), "LZC_")
    params = {p.name: torch.as_tensor(p.testval()) for p in kt.hypers}
    T.lazy_kernel_matvec(kt, params, x, torch.ones(100), block=32)
    assert spy.take() == (4, 0)


def test_pivoted_cholesky_recovery_and_breakdown_guard():
    """A rank-5 gram from rank 10: exact recovery, and past the fifth pivot
    the residual diagonal underflows — the guard writes zero columns, not a
    1/sqrt(underflow) blow-up."""
    with floatx("float64"):
        rng = np.random.default_rng(4)
        w = rng.standard_normal((80, 5))
        k = w @ w.T
        kj, kt = jnp.asarray(k), torch.as_tensor(k)
        want = J.pivoted_cholesky(lambda j: kj[:, j], jnp.diagonal(kj), rank=10)
        got = T.pivoted_cholesky(lambda j: kt[:, j], torch.diagonal(kt), rank=10)
        assert_close(got, want, "float64")
        np.testing.assert_allclose(got.numpy() @ got.numpy().T, k, atol=1e-10)
        assert np.isfinite(got.numpy()).all()
        assert np.abs(got.numpy()[:, 5:]).max() < 1e-6
        # exactly singular: a zero diagonal gives zero columns throughout
        zero = torch.zeros((6, 6), dtype=torch.float64)
        assert float(T.pivoted_cholesky(lambda j: zero[:, j], torch.diagonal(zero),
                                        rank=3).abs().max()) == 0.0


def test_woodbury_inverse_and_inverse_sqrt():
    with floatx("float64"):
        rng = np.random.default_rng(5)
        lf, sigma2 = rng.standard_normal((40, 6)), 0.3
        p = lf @ lf.T + sigma2 * np.eye(40)
        v = rng.standard_normal(40)
        vs = rng.standard_normal((40, 3))
        jw = J.woodbury_preconditioner(jnp.asarray(lf), sigma2)
        tw = T.woodbury_preconditioner(torch.as_tensor(lf), sigma2)
        for vec in (v, vs):
            assert_close(tw[0](torch.as_tensor(vec)), jw[0](jnp.asarray(vec)), "float64")
            assert_close(tw[1](torch.as_tensor(vec)), jw[1](jnp.asarray(vec)), "float64")
        assert_close(tw[2], jw[2], "float64")
        pt = torch.as_tensor(p)
        np.testing.assert_allclose(tw[0](pt @ torch.as_tensor(v)).numpy(), v, atol=1e-10)
        w = tw[1](pt @ tw[1](torch.as_tensor(v)))
        np.testing.assert_allclose(w.numpy(), v, atol=1e-10)
        np.testing.assert_allclose(float(tw[2]), np.linalg.slogdet(p)[1], rtol=1e-12)


def _pcg_case(n=48, seed=6):
    """An SE gram + noise and its rank-24 pivoted preconditioner."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n)).reshape(-1, 1)
    k = np.exp(-0.5 * (x - x.T) ** 2) + 0.05 * np.eye(n)
    kf = k - 0.05 * np.eye(n)
    kt = torch.as_tensor(kf)
    lf = T.pivoted_cholesky(lambda j: kt[:, j], torch.diagonal(kt), rank=24)
    return k, lf.numpy(), rng


def test_pcg_single_and_multi_rhs():
    with floatx("float64"):
        k, lf, rng = _pcg_case()
        b, bs = rng.standard_normal(48), rng.standard_normal((4, 48))
        kj, kt = jnp.asarray(k), torch.as_tensor(k)
        pj = J.woodbury_preconditioner(jnp.asarray(lf), 0.05)[0]
        pt = T.woodbury_preconditioner(torch.as_tensor(lf), 0.05)[0]
        for rhs in (b, bs):
            want = J.pcg_solve(lambda v: kj @ v, jnp.asarray(rhs), pj, maxiter=100)
            got = T.pcg_solve(lambda v: kt @ v, torch.as_tensor(rhs), pt, maxiter=100)
            assert_close(got, want, "float64")
            np.testing.assert_allclose(got.numpy(), np.linalg.solve(k, rhs.T).T, atol=1e-5)


def test_probe_solves_freeze_each_column():
    """The gradient's probe solves: each column keeps its own scalars and
    stops (frozen) at its own convergence — the JAX package's vmapped
    single-vector PCG, not the shared multi-RHS form — so a batch of
    columns equals the columns solved one at a time, and the JAX vmap."""
    with floatx("float64"):
        k, lf, rng = _pcg_case(seed=7)
        kt = torch.as_tensor(k)
        pt = T.woodbury_preconditioner(torch.as_tensor(lf), 0.05)[0]
        # columns of very different difficulty: one converges at once
        z = rng.standard_normal((48, 3))
        z[:, 0] = k @ np.linalg.solve(k, lf[:, 0])
        batch = T._pcg_columns(lambda v: kt @ v, torch.as_tensor(z), pt, 1e-6, 100)
        for i in range(3):
            one = T._pcg_columns(lambda v: kt @ v, torch.as_tensor(z[:, i]), pt, 1e-6, 100)
            assert_close(batch[:, i], one, "float64")
        pj = J.woodbury_preconditioner(jnp.asarray(lf), 0.05)[0]
        kj = jnp.asarray(k)
        want = jax.vmap(lambda zz: J.pcg_solve(lambda v: kj @ v, zz, pj, maxiter=100))(
            jnp.asarray(z.T))
        assert_close(batch.T, want, "float64")


def _precond_setup(n, seed, prefix):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 20, n)).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)
    kj, kt = _se(x, prefix)
    params = {p.name: np.asarray(p.testval()) for p in kj.hypers}
    return x, y, kj, kt, params


def test_preconditioned_nll_value_and_gradient():
    """Value, info and the stochastic-trace gradient in params, noise and y
    (blocks of 64: ragged at n=160) against the JAX package, from its
    probes; the value against the dense NLL."""
    n, probes = 160, 16
    kw = dict(rank=40, cg_iters=300, probes=probes, lanczos_iters=30, block=64)
    with floatx("float64"):
        x, y, kj, kt, params = _precond_setup(n, 8, "PC_")

        def f(p, nv, yy):
            return J.preconditioned_gp_nll(kj, p, jnp.asarray(x), yy, noise_var=nv, **kw)

        (want, info_w), gw = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.float64(0.05), jnp.asarray(y))
        pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
        nv = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
        yt = torch.tensor(y, requires_grad=True)
        got, info = T.preconditioned_gp_nll(kt, pt, torch.as_tensor(x), yt, nv,
                                            seed=_jax_probes(0, probes, n), **kw)
        got.backward()
        assert_close(got.detach(), want, "float64")
        assert_close({k: v.detach() for k, v in info.items()}, dict(info_w), "float64")
        assert_close({k: v.grad for k, v in pt.items()}, gw[0], "float64")
        assert_close(nv.grad, gw[1], "float64")
        assert_close(yt.grad, gw[2], "float64")
        kd = kt.cov({k: torch.as_tensor(v) for k, v in params.items()},
                    torch.as_tensor(x)).numpy() + 0.05 * np.eye(n)
        chol = np.linalg.cholesky(kd)
        z = np.linalg.solve(chol, y)
        exact = 0.5 * z @ z + np.log(np.diag(chol)).sum() + 0.5 * n * np.log(2 * np.pi)
        assert float(info["cg_rel_residual"]) < 1e-2
        np.testing.assert_allclose(float(got), exact, rtol=5e-3)
        # the y-gradient is K^{-1} r exactly (to the CG tolerance)
        np.testing.assert_allclose(yt.grad.numpy(), np.linalg.solve(kd, y), rtol=5e-2,
                                   atol=5e-3)


def test_preconditioned_nll_with_a_mean_and_its_gram_calls(monkeypatch):
    """The mean's gradient (-alpha) against the JAX package; and the gram
    calls of one value-and-gradient evaluation equal the count the slab
    passes predict: (matvecs + gradient passes) x slabs + diagonal blocks
    + pivot columns (one K1 call a gram for the SE)."""
    n, probes = 100, 8
    kw = dict(rank=20, cg_iters=200, probes=probes, lanczos_iters=20, block=32)
    with floatx("float64"):
        x, y, kj, kt, params = _precond_setup(n, 9, "PM_")
        mean = 0.3 + 0.1 * np.cos(x[:, 0])
        gw = jax.grad(lambda m: J.preconditioned_gp_nll(
            kj, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            jnp.asarray(y), 0.1, mean=m, **kw)[0])(jnp.asarray(mean))
        spy = KernelSpy(monkeypatch)
        T.reset_counts()
        mt = torch.tensor(mean, requires_grad=True)
        pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
        got, _ = T.preconditioned_gp_nll(kt, pt, torch.as_tensor(x), torch.as_tensor(y), 0.1,
                                         mean=mt, seed=_jax_probes(0, probes, n), **kw)
        got.backward()
        assert_close(mt.grad, gw, "float64")
        c = T.counts
        slabs = -(-n // 32)
        predicted = (c["matvecs"] + c["grad_passes"]) * slabs + c["diag_blocks"] + c["columns"]
        assert c["columns"] == 20 and c["diag_blocks"] == slabs and c["grad_passes"] == 1
        assert spy.take() == (predicted, 0)
        assert c["reads"] > 0


def test_full_fp32_restores_the_callers_precision():
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with T.full_fp32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)
