"""Port parity: grams (weighted distances and dots, the per-feature sum
and product reductions) and the fused stationary-gram kernel (K1),
including the inputs the kernel algebra reaches: a 0-d amplitude beside a
rate of R rows, a dims-restricted slice and a shared rate Param.

The JAX side of K1 is ``_xla_form`` and ``KernelStationary.cov``, which
take the plain XLA path off the TPU; the port's CPU path is the kernel's
plain version ``_plain_form``.  The kernel itself is checked against that
plain version on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.ops import gram as jgram
from g3py_tpu.ops.pallas_gram import _xla_form
from g3py_tpu_torch.ops import gram as tgram
from g3py_tpu_torch.ops.stationary_gram import KINDS, _plain_form, stationary_gram

from torch_parity import check, floatx, assert_close

KIND_NAMES = sorted(KINDS)
RAGGED = [(13, 7, 3), (5, 11, 1), (9, 9, 6)]


def _inputs(seed, m, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)), rng.standard_normal((n, d)),
            rng.uniform(0.3, 1.2, d), np.array(1.7), np.array(0.8))


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("kind", KIND_NAMES)
def test_stationary_gram_matches_xla_form(kind, name):
    for i, shape in enumerate(RAGGED):
        check(lambda *a: _xla_form(kind, *a), lambda *a: stationary_gram(kind, *a),
              *_inputs(i, *shape), name=name)


def test_stationary_gram_rejects_unknown_kind():
    x = torch.zeros(2, 1)
    with pytest.raises(ValueError):
        stationary_gram("periodic", x, x, torch.ones(1), torch.ones(()))


def test_stationary_gram_cpu_gradient_matches_plain_autograd():
    x1, x2, rate, var, alpha = (torch.as_tensor(a).requires_grad_(True)
                                for a in _inputs(3, 6, 4, 2))
    stationary_gram("rq", x1, x2, rate, var, alpha).sum().backward()
    got = [t.grad.clone() for t in (x1, x2, rate, var, alpha)]
    leaves = [t.detach().requires_grad_(True) for t in (x1, x2, rate, var, alpha)]
    _plain_form("rq", *leaves).sum().backward()
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad)


@pytest.mark.parametrize("exact", [False, True])
def test_weighted_sqdist_and_sqdist(exact):
    x1, x2, rate, _, _ = _inputs(4, 7, 5, 3)
    check(lambda a, b, r: jgram.weighted_sqdist(a, b, r, exact=exact),
          lambda a, b, r: tgram.weighted_sqdist(a, b, r, exact=exact), x1, x2, rate)
    check(jgram.sqdist, tgram.sqdist, x1, x2)
    with floatx("float64"):
        out = tgram.weighted_sqdist(torch.as_tensor(x1), torch.as_tensor(x2))
        assert out.dtype == torch.float64  # the accumulator follows the input


def test_pairwise_sum_per_dim():
    x1, x2, rate, _, _ = _inputs(5, 6, 4, 3)
    check(lambda a, b, w: jgram.pairwise_sum(a, b, lambda u, v, wd: (u - v) ** 2 * wd, w),
          lambda a, b, w: tgram.pairwise_sum(a, b, lambda u, v, wd: (u - v) ** 2 * wd, w),
          x1, x2, rate)


def _kernel_pair(cls_name, name, x):
    jk = getattr(g3, cls_name)(x, name=name)
    tk = getattr(g3t, cls_name)(x, name=name)
    jk.check_hypers("P_")
    tk.check_hypers("P_")
    return jk, tk


@pytest.mark.parametrize("cls_name", ["SE", "MAT32", "MAT52", "RQ"])
def test_kernel_cov_matches_jax(cls_name):
    rng = np.random.default_rng(6)
    x1 = rng.standard_normal((10, 3)).astype(np.float32)
    x2 = rng.standard_normal((7, 3)).astype(np.float32)
    jk, tk = _kernel_pair(cls_name, cls_name, x1)
    params = {p.name: rng.uniform(0.4, 1.5, p.shape).astype(np.float32) for p in jk.hypers}
    assert [p.name for p in tk.hypers] == list(params)
    assert tk._gram_dispatchable() == tk._gram_kind
    tparams = {k: torch.as_tensor(v) for k, v in params.items()}
    for args in ((x1, x2), (x1,)):
        want = np.asarray(jk.cov(params, *args))
        got = tk.cov(tparams, *[torch.as_tensor(a) for a in args])
        assert_close(got, want)


def test_subclass_overriding_k_takes_generic_path():
    class JSE2(g3.SE):
        def k(self, params, d):
            return g3.SE.k(self, params, 2.0 * d)

    class TSE2(g3t.SE):
        def k(self, params, d):
            return g3t.SE.k(self, params, 2.0 * d)

    rng = np.random.default_rng(7)
    x1 = rng.standard_normal((9, 2)).astype(np.float32)
    x2 = rng.standard_normal((4, 2)).astype(np.float32)
    jk, tk = JSE2(x1, name="S2"), TSE2(x1, name="S2")
    jk.check_hypers("P_")
    tk.check_hypers("P_")
    assert tk._gram_dispatchable() is None
    params = {p.name: rng.uniform(0.5, 1.5, p.shape).astype(np.float32) for p in jk.hypers}
    want = np.asarray(jk.cov(params, x1, x2))
    got = tk.cov({k: torch.as_tensor(v) for k, v in params.items()},
                 torch.as_tensor(x1), torch.as_tensor(x2))
    assert_close(got, want)
    plain = g3t.SE(x1, name="S2")
    plain.check_hypers("P_")
    base = plain.cov({k: torch.as_tensor(v) for k, v in params.items()},
                     torch.as_tensor(x1), torch.as_tensor(x2))
    assert not np.allclose(got.numpy(), base.numpy())  # k() override honored


def test_noise_kernel_square_and_cross():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 2)).astype(np.float32)
    xq = rng.standard_normal((3, 2)).astype(np.float32)
    jk = g3.SE(x, name="K") + g3.KernelNoise(name="Noise")
    tk = g3t.SE(x, name="K") + g3t.KernelNoise(name="Noise")
    for k in (jk, tk):
        k.check_dims(x)
        k.check_hypers("P_")
    params = {p.name: rng.uniform(0.5, 1.5, p.shape).astype(np.float32) for p in jk.hypers}
    tparams = {k: torch.as_tensor(v) for k, v in params.items()}
    for args in ((x,), (xq, x)):
        assert_close(tk.cov(tparams, *[torch.as_tensor(a) for a in args]),
                     np.asarray(jk.cov(params, *args)))



def test_weighted_dot_and_pairwise_prod():
    x1, x2, rate, _, _ = _inputs(9, 6, 4, 3)
    check(lambda a, b, w: jgram.weighted_dot(a, b, w),
          lambda a, b, w: tgram.weighted_dot(a, b, w), x1, x2, rate)
    check(jgram.weighted_dot, tgram.weighted_dot, x1, x2)
    check(lambda a, b, w: jgram.pairwise_prod(a, b, lambda u, v, wd: jnp.cos((u - v) * wd), w),
          lambda a, b, w: tgram.pairwise_prod(a, b, lambda u, v, wd: torch.cos((u - v) * wd), w),
          x1, x2, rate, name="float64")


def test_pairwise_reductions_take_rows_of_per_dim_vectors():
    """(R, d) per-dimension vectors give (R, N, M), each row its own."""
    x1, x2, _, _, _ = _inputs(10, 5, 4, 3)
    w = np.random.default_rng(11).uniform(0.5, 2.0, (3, 3))
    with floatx("float64"):
        t1, t2, tw = (torch.as_tensor(a) for a in (x1, x2, w))
        for reduce in (tgram.pairwise_sum, tgram.pairwise_prod):
            rows = reduce(t1, t2, lambda u, v, wd: torch.cos((u - v) * wd), tw)
            assert rows.shape == (3, 5, 4)
            for r in range(3):
                one = reduce(t1, t2, lambda u, v, wd: torch.cos((u - v) * wd), tw[r])
                torch.testing.assert_close(rows[r], one, rtol=1e-14, atol=0)
        assert (tgram.pairwise_prod(t1[:, :0], t2[:, :0], torch.minimum) == 1).all()


@pytest.mark.parametrize("kind", KIND_NAMES)
def test_stationary_gram_shares_a_0d_var_across_rows(kind):
    """A fixed amplitude (0-d) beside a (R, d) rate is one value for every
    row (a product's pinned 1 under a sampler's rows)."""
    x1, x2, _, _, alpha = _inputs(12, 6, 5, 2)
    rates = np.random.default_rng(13).uniform(0.3, 1.2, (4, 2))
    with floatx("float64"):
        t1, t2, tr = (torch.as_tensor(a) for a in (x1, x2, rates))
        one = torch.tensor(1.0, dtype=torch.float64)
        a0 = torch.as_tensor(alpha)
        rows = stationary_gram(kind, t1, t2, tr, one, a0)
        assert rows.shape == (4, 6, 5)
        for r in range(4):
            torch.testing.assert_close(rows[r], stationary_gram(kind, t1, t2, tr[r], one, a0),
                                       rtol=1e-14, atol=0)


def test_dims_restricted_and_shared_rate_kernels_match_jax():
    """SE on dims [2] of 3 and two SE factors sharing one rate Param, both
    through the fused gram's path, against the JAX package's covs."""
    rng = np.random.default_rng(14)
    x1, x2 = rng.standard_normal((8, 3)), rng.standard_normal((5, 3))
    with floatx("float64"):
        out = []
        for lib in (g3, g3t):
            shared = lib.Param("P_shared_rate", shape=(3,), prior=lib.FlatExp())
            k = (lib.SE([2], name="SEd")
                 + lib.SE(x1, name="SEa", metric=lib.ARD_L2(x1, rate=shared))
                 * lib.MAT52(x1, name="Ma", metric=lib.ARD_L2(x1, rate=shared)))
            k.check_dims(x1)
            k.check_hypers("P_")
            out.append(k)
        jk, tk = out
        names = [p.name for p in tk.hypers]
        assert names == [p.name for p in jk.hypers] and names.count("P_shared_rate") == 2
        assert tk.k1._gram_dispatchable() == "se" and tk.k2.k1._gram_dispatchable() == "se"
        params = {p.name: rng.uniform(0.4, 1.5, p.shape) for p in jk.hypers}
        tparams = {k: torch.as_tensor(v) for k, v in params.items()}
        for args in ((x1, x2), (x1,)):
            assert_close(tk.cov(tparams, *[torch.as_tensor(a) for a in args]),
                         np.asarray(jk.cov(params, *args)), "float64")
