"""Port parity of ``g3py_tpu_torch/ops/kron.py`` against
``g3py_tpu.ops.kron`` in float64 at 1e-10: the Kronecker NLL with its
eigh-free gradient in the grams, the noise and y (D = 2 and 3); the cross
statistics; the masked (incomplete-grid) NLL, its diagnostics and its BBMM
gradient with the JAX package's probes injected; the SKI taps, operator,
prior diagonal, NLL and solve (the JAX package densifies W for its MXU, the
port gathers and scatter-adds: the same operator).  The JAX side runs in one
program a quantity, compiled with ``torch_parity.FAST_COMPILE``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from g3py_tpu.ops import kron as JK
from g3py_tpu_torch.ops import kron as TK

from torch_parity import assert_close, floatx, jax_compiled

F64 = "float64"


def _spd_grams(sizes, seed):
    """SE grams on sorted points (near-degenerate spectra, as smooth grams
    have) plus a little jitter."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = np.sort(rng.uniform(0, 3, n))
        out.append(1.3 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 1e-6 * np.eye(n))
    return out


def _probes(seed, p, n):
    """The JAX package's SLQ probes (PRNGKey(seed)) and gradient probes
    (PRNGKey(seed + 104729)) of its masked/SKI NLLs."""
    slq = np.asarray(random.rademacher(random.PRNGKey(seed), (p, n), dtype=jnp.float64))
    g = 2.0 * random.bernoulli(random.PRNGKey(seed + 104729), 0.5, (p, n)) - 1.0
    return {"slq": slq, "grad": np.asarray(g, np.float64)}


def _t(*xs):
    return [torch.tensor(np.asarray(x), dtype=torch.float64, requires_grad=True) for x in xs]


@pytest.mark.parametrize("sizes", [(5, 4), (4, 3, 3)])
def test_kron_nll_and_its_eigh_free_gradient(sizes):
    ks = _spd_grams(sizes, seed=len(sizes))
    rng = np.random.default_rng(1)
    y = rng.standard_normal(sizes)
    s2 = 0.3
    with floatx(F64):
        val, grads = jax_compiled(jax.value_and_grad(JK.kron_gp_nll, argnums=(0, 1, 2)),
                                  tuple(jnp.asarray(k) for k in ks), jnp.asarray(s2),
                                  jnp.asarray(y))
        tk = _t(*ks)
        ts2, ty = _t(s2, y)
        tval = TK.kron_gp_nll(tk, ts2, ty)
        tg = torch.autograd.grad(tval, tk + [ts2, ty])
    assert_close(tval, val, F64)
    assert_close([g.numpy() for g in tg[:-2]], [np.asarray(g) for g in grads[0]], F64)
    assert_close(tg[-2], grads[1], F64)
    assert_close(tg[-1], grads[2], F64)
    # the dense gram's NLL
    big = ks[0]
    for k in ks[1:]:
        big = np.kron(big, k)
    s = big + s2 * np.eye(len(big))
    dense = 0.5 * (np.linalg.slogdet(s)[1] + y.ravel() @ np.linalg.solve(s, y.ravel())
                   + len(big) * np.log(2 * np.pi))
    np.testing.assert_allclose(float(tval), dense, rtol=1e-10)
    with pytest.raises(NotImplementedError, match="item 16"):
        TK.kron_gp_nll(tk, ts2, ty, shard=("mesh", "dp"))


def test_cross_statistics_and_the_eigen_solve():
    ks = _spd_grams((5, 4), seed=3)
    rng = np.random.default_rng(2)
    cs = [rng.standard_normal((6, 5)), rng.standard_normal((6, 4))]
    y = rng.standard_normal((5, 4))
    kdiag = np.full(6, 5.0)
    kqq = 5.0 * np.eye(6) + 0.1
    with floatx(F64):
        qs, lams = JK.kron_eigs([jnp.asarray(k) for k in ks])
        dinv = JK.kron_dinv(lams, 0.2)
        alpha = JK.kron_solve_eig(qs, dinv, jnp.asarray(y))
        want = dict(alpha=alpha, mean=JK.cross_mean([jnp.asarray(c) for c in cs], alpha),
                    var=JK.cross_var([jnp.asarray(c) for c in cs], qs, dinv, jnp.asarray(kdiag)),
                    cov=JK.cross_cov([jnp.asarray(c) for c in cs], qs, dinv, jnp.asarray(kqq),
                                     chunk=7))
        tq, tl = TK.kron_eigs([torch.as_tensor(k) for k in ks])
        td = TK.kron_dinv(tl, 0.2)
        ta = TK.kron_solve_eig(tq, td, torch.as_tensor(y))
        tcs = [torch.as_tensor(c) for c in cs]
        got = dict(alpha=ta, mean=TK.cross_mean(tcs, ta),
                   var=TK.cross_var(tcs, tq, td, torch.as_tensor(kdiag)),
                   cov=TK.cross_cov(tcs, tq, td, torch.as_tensor(kqq), chunk=7))
    assert_close(got, {k: np.asarray(v) for k, v in want.items()}, F64)


def _masked_case(seed=4):
    ks = _spd_grams((6, 5), seed=seed)
    rng = np.random.default_rng(seed)
    keep = np.sort(rng.choice(30, 21, replace=False))
    idx = np.stack(np.unravel_index(keep, (6, 5)))
    y = rng.standard_normal(len(keep))
    return ks, idx, y


def test_masked_nll_diagnostics_and_bbmm_gradient():
    ks, idx, y = _masked_case()
    s2 = 0.25
    kw = dict(rank=8, cg_iters=60, probes=6, lanczos_iters=12)
    with floatx(F64):
        def jf(k_, s_, y_):
            nll, info = JK.masked_kron_nll(k_, s_, y_, jnp.asarray(idx, jnp.int32), (6, 5),
                                           kw["rank"], kw["cg_iters"], kw["probes"],
                                           kw["lanczos_iters"], 3)
            return nll, info

        (val, info), grads = jax_compiled(
            jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True),
            tuple(jnp.asarray(k) for k in ks), jnp.asarray(s2), jnp.asarray(y))
        mv = JK.masked_kron_matvec([jnp.asarray(k) for k in ks], tuple(jnp.asarray(idx)),
                                   (6, 5), s2, jnp.asarray(y))
        tk = _t(*ks)
        ts2, ty = _t(s2, y)
        tval, tinfo = TK.masked_kron_nll(tk, ts2, ty, torch.as_tensor(idx), (6, 5),
                                         seed=_probes(3, kw["probes"], len(y)), **kw)
        tg = torch.autograd.grad(tval, tk + [ts2, ty])
        tmv = TK.masked_kron_matvec([torch.as_tensor(k) for k in ks], torch.as_tensor(idx),
                                    (6, 5), s2, torch.as_tensor(y))
    assert_close(tval, val, F64)
    assert_close({k: tinfo[k] for k in info}, {k: np.asarray(v) for k, v in info.items()}, F64)
    assert_close([g.numpy() for g in tg[:2]], [np.asarray(g) for g in grads[0]], F64)
    assert_close(tg[2:], [grads[1], grads[2]], F64)
    assert_close(tmv, mv, F64)
    b = np.random.default_rng(5).standard_normal((len(y), 3))
    with floatx(F64):
        want = JK.masked_cross_solve([jnp.asarray(k) for k in ks], s2, jnp.asarray(idx), (6, 5),
                                     jnp.asarray(b), rank=8, cg_iters=80)
        got = TK.masked_cross_solve([torch.as_tensor(k) for k in ks], s2, torch.as_tensor(idx),
                                    (6, 5), torch.as_tensor(b), rank=8, cg_iters=80)
    assert_close(got, want, F64)


def _ski_case(seed=6, n=30, shape=(9, 8)):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0.3, 2.6, n), rng.uniform(-1.0, 1.0, n)], 1)
    geom = [(0.0, 3.0 / (shape[0] - 1), shape[0]), (-1.3, 2.6 / (shape[1] - 1), shape[1])]
    return x, geom, shape


def test_ski_taps_operator_and_prior_diagonal():
    x, geom, shape = _ski_case()
    ks = _spd_grams(shape, seed=7)
    v = np.random.default_rng(8).standard_normal((len(x), 2))
    g = np.random.default_rng(9).standard_normal(shape + (2,))
    with floatx(F64):
        jt = [JK.cubic_interp_axis(lo, h, m, jnp.asarray(x[:, i])) for i, (lo, h, m)
              in enumerate(geom)]
        jidx, jw = tuple(t[0] for t in jt), tuple(t[1] for t in jt)
        jwv, jwtv, jrow = JK.ski_operator(jidx, jw, shape)
        want = dict(w=jw, wv=jwv(jnp.asarray(g)), wtv=jwtv(jnp.asarray(v)),
                    row=jrow(3), diag=JK.ski_prior_diag([jnp.asarray(k) for k in ks], jidx, jw),
                    dense=JK.ski_dense_w(jidx, jw, shape))
        tt = [TK.cubic_interp_axis(lo, h, m, torch.as_tensor(x[:, i])) for i, (lo, h, m)
              in enumerate(geom)]
        tidx, tw = tuple(t[0] for t in tt), tuple(t[1] for t in tt)
        twv, twtv, trow = TK.ski_operator(tidx, tw, shape)
        got = dict(w=tw, wv=twv(torch.as_tensor(g)), wtv=twtv(torch.as_tensor(v)),
                   row=trow(torch.tensor(3)),
                   diag=TK.ski_prior_diag([torch.as_tensor(k) for k in ks], tidx, tw),
                   dense=TK.ski_dense_w(tidx, tw, shape))
    for a, b in zip(tidx, jidx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_close(got, {k: [np.asarray(u) for u in v_] if isinstance(v_, (list, tuple))
                       else np.asarray(v_) for k, v_ in want.items()}, F64)


def test_ski_nll_gradient_and_solve():
    x, geom, shape = _ski_case()
    ks = _spd_grams(shape, seed=10)
    y = np.sin(x[:, 0]) + 0.1 * np.random.default_rng(11).standard_normal(len(x))
    s2 = 0.05
    kw = dict(rank=10, cg_iters=80, probes=6, lanczos_iters=15)
    b = np.random.default_rng(12).standard_normal((len(x), 2))
    with floatx(F64):
        jt = [JK.cubic_interp_axis(lo, h, m, jnp.asarray(x[:, i])) for i, (lo, h, m)
              in enumerate(geom)]
        jidx, jw = jnp.stack([t[0] for t in jt]), jnp.stack([t[1] for t in jt])

        def jf(k_, s_, y_):
            return JK.ski_nll(k_, s_, y_, jidx, jw, shape, kw["rank"], kw["cg_iters"],
                              kw["probes"], kw["lanczos_iters"], 2)

        (val, info), grads = jax_compiled(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                                             has_aux=True),
                                          tuple(jnp.asarray(k) for k in ks), jnp.asarray(s2),
                                          jnp.asarray(y))
        want_solve = JK.ski_solve([jnp.asarray(k) for k in ks], s2, jidx, jw, shape,
                                  jnp.asarray(b), rank=10, cg_iters=100)
        tt = [TK.cubic_interp_axis(lo, h, m, torch.as_tensor(x[:, i])) for i, (lo, h, m)
              in enumerate(geom)]
        tidx, tw = torch.stack([t[0] for t in tt]), torch.stack([t[1] for t in tt])
        tk = _t(*ks)
        ts2, ty = _t(s2, y)
        tval, tinfo = TK.ski_nll(tk, ts2, ty, tidx, tw, shape,
                                 seed=_probes(2, kw["probes"], len(y)), **kw)
        tg = torch.autograd.grad(tval, tk + [ts2, ty])
        got_solve = TK.ski_solve([torch.as_tensor(k) for k in ks], s2, tidx, tw, shape,
                                 torch.as_tensor(b), rank=10, cg_iters=100)
    assert_close(tval, val, F64)
    assert_close({k: tinfo[k] for k in info}, {k: np.asarray(v) for k, v in info.items()}, F64)
    assert_close([g.numpy() for g in tg[:2]], [np.asarray(g) for g in grads[0]], F64)
    assert_close(tg[2:], [grads[1], grads[2]], F64)
    assert_close(got_solve, want_solve, F64)
