"""Port parity of the state-space scans (``g3py_tpu_torch/ops/ssm.py``)
against the JAX package's ``g3py_tpu/ops/ssm.py`` (the leaves are
``tests/test_torch_ssm_leaves.py``'s): the associative scan against
``lax.associative_scan`` on the filter and smoother monoids (forward and
reverse, odd and even n), the filter, the NLL, its quad/logdet split and
the smoother (shared and per-row emissions), the prior state draw from the
JAX package's normals, and the chunked NLL and smoother (plain, per-row,
payload, blocks-on-the-fly and split forms, with a small chunk) against the
plain scans — float64 against JAX x64 at 1e-10, float32 at rtol 1e-4 /
atol 1e-5, the JAX side one compiled program a check
(``torch_parity.jax_compiled``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, random

import g3py_tpu as g3
from g3py_tpu.ops import ssm as J
import g3py_tpu_torch as g3t
from g3py_tpu_torch.ops import ssm as T

from torch_parity import assert_close, floatx, jax_compiled, to_numpy

KERNELS = {
    "ou": lambda L, t: L.OU(t),
    "mat32": lambda L, t: L.MAT32(t),
    "mat52": lambda L, t: L.MAT52(t),
    "se": lambda L, t: L.SE(t),
    "sm": lambda L, t: L.SM(t),
    "cos": lambda L, t: L.COS(t),
    "sin": lambda L, t: L.SIN(t),
    "sum": lambda L, t: L.MAT32(t) + L.OU(t) + L.COS(t),
    "quasi_periodic": lambda L, t: L.SIN(t) * L.MAT32(t),
}


def _series(n=19, seed=0, dup=True):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 10.0, n)).reshape(-1, 1)
    if dup:
        t[5] = t[4]                                  # a dt = 0 step
    y = np.sin(t[:, 0]) + 0.1 * rng.standard_normal(n)
    return t, y


def _leaves_and_params(which, t, y, factor=1.1):
    """The same kernel in both packages (through a GP, so the hypers are
    registered and named alike) and params moved off the defaults."""
    jgp = g3.GP(space=t, kernel=KERNELS[which](g3, t), name="L" + which)
    jgp.observed(t, y)
    tgp = g3t.GP(space=t, kernel=KERNELS[which](g3t, t), name="L" + which)
    tgp.observed(t, y)
    params = {k: np.asarray(v) * factor for k, v in jgp.params.items()}
    return J.ssm_leaves(jgp.f_kernel), T.ssm_leaves(tgp.f_kernel), params


def _jp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _tp(params):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


N = 15        # one length for the filter, the smoother and the chunked paths


def _filter_inputs(n=N, seed=1):
    """(A, Q, H, y, tl, params, dt) of MAT32 + OU + COS over n steps with a
    dt = 0 row, the blocks from the port (the leaves' parity is
    ``tests/test_torch_ssm_leaves.py``'s)."""
    t, y = _series(n, seed)
    _, tl, params = _leaves_and_params("sum", t, y)
    dt = np.concatenate([[0.0], np.diff(t[:, 0])]).astype(g3t.settings.floatx)
    with torch.no_grad():
        a, q, _, h = (to_numpy(v) for v in T.ssm_blocks(tl, _tp(params), torch.as_tensor(dt)))
    return a, q, h, y, tl, params, dt


def _lax_scans(a, q, h, r, y, obs):
    """``lax.associative_scan`` on the filter elements (both directions)
    and on the smoothing elements built from the forward filter (both
    directions), as one program."""
    jel = J._filter_elements(a, q, h, r, y, obs)
    filt = [lax.associative_scan(J._filter_combine, jel, reverse=rev) for rev in (False, True)]
    m_f, p_f = filt[0][1:3]
    sel = (a[1:], m_f[:-1], p_f[:-1])
    smooth = [lax.associative_scan(J._smoother_combine, sel, reverse=rev) for rev in (True, False)]
    return {"elements": jel, "filter": filt, "smoother": smooth}


@pytest.mark.parametrize("n", [N - 1, N])
def test_scan_matches_lax_on_the_filter_and_smoother_monoids(n):
    with floatx("float64"):
        a, q, h, y = _filter_inputs(n)[:4]
        obs = np.ones(n, bool)
        obs[3] = False
        r = 0.05
        want = to_numpy(jax_compiled(_lax_scans, a, q, h, r, y, obs))
        tel = T._filter_elements(*_t(a, q, h), torch.tensor(r, dtype=torch.float64),
                                 *_t(y, obs))
        assert_close(tel, want["elements"], "float64")
        for i, reverse in enumerate((False, True)):
            got = T.associative_scan(T._filter_combine, tel, reverse=reverse)
            assert_close(got, want["filter"][i], "float64", err_msg=f"filter reverse={reverse}")
        m_f, p_f = want["filter"][0][1:3]
        sel = (a[1:], m_f[:-1], p_f[:-1])
        for i, reverse in enumerate((True, False)):
            got = T.associative_scan(T._smoother_combine, _t(*sel), reverse=reverse)
            assert_close(got, want["smoother"][i], "float64",
                         err_msg=f"smoother reverse={reverse}")


def test_scan_keeps_batch_axes_ahead_of_the_scanned_one():
    """Elements with a leading row axis scan as that many independent
    scans (the rows of a params dict)."""
    with floatx("float64"):
        a, q, h, y = _filter_inputs()[:4]
        ys = np.stack([y, 0.5 * y, y[::-1].copy()])
        ones = torch.ones(N, dtype=torch.bool)
        rows = T._filter_scan(T._filter_elements(*_t(a, q, h), 0.05, torch.as_tensor(ys), ones))
        for i in range(3):
            one = T._filter_scan(T._filter_elements(*_t(a, q, h), 0.05, torch.as_tensor(ys[i]),
                                                    ones))
            assert_close([x[i] for x in rows], one, "float64")


@pytest.mark.parametrize("name,per_row", [("float64", False), ("float64", True),
                                          ("float32", True)])
def test_filter_nll_split_and_smoother(name, per_row):
    with floatx(name):
        a, q, h, y = _filter_inputs()[:4]
        rng = np.random.default_rng(5)
        obs = rng.uniform(size=N) > 0.2
        if per_row:                                  # the multi-output emissions
            h = h[None, :] * rng.uniform(0.5, 1.5, (N, 1))
            r = rng.uniform(0.02, 0.1, N)
        else:
            r = np.asarray(0.05)
        args = [np.asarray(v, name) for v in (a, q, h, r, y)]
        jargs = list(map(jnp.asarray, args)) + [jnp.asarray(obs)]
        targs = _t(*args) + [torch.as_tensor(obs)]

        def jax_side(*z):
            nll = J.parallel_kalman_nll(*z)
            return (nll, J.parallel_kalman_quad_logdet(*z), J.parallel_kalman_filter(*z),
                    J.parallel_smoother(z[0], z[1], nll[1], nll[2]))

        want = jax_compiled(jax_side, *jargs)
        got = T.parallel_kalman_nll(*targs)
        assert_close(got, want[0], name)
        assert_close(T.parallel_kalman_quad_logdet(*targs), want[1], name)
        assert_close(T.parallel_kalman_filter(*targs), want[2], name)
        assert_close(T.parallel_smoother(targs[0], targs[1], got[1], got[2]), want[3], name)


def test_prior_state_draw_from_the_jax_normals():
    with floatx("float64"):
        a, q = _filter_inputs()[:2]
        key = random.PRNGKey(7)
        want = jax.jit(J.ssm_prior_state_sample)(jnp.asarray(a), jnp.asarray(q), key)
        eps = np.array(random.normal(key, a.shape[:-1], dtype=jnp.float64))
        got = T.ssm_prior_state_sample(*_t(a, q, eps))
        assert_close(got, want, "float64")
        many = T.ssm_prior_state_sample(*_t(a, q, np.stack([eps, 2 * eps])))
        assert_close(many[1], 2 * to_numpy(got), "float64")
        seeded = T.ssm_prior_state_sample(*_t(a, q), 3)
        assert seeded.shape == got.shape and torch.isfinite(seeded).all()


def _per_row(tl, tp, dtt, seed=2):
    """A two-output LMC mix of the state model: (idx, W, Hq, r_vec) and the
    per-row (h, r) they give."""
    rng = np.random.default_rng(seed)
    it = torch.as_tensor(rng.integers(0, 2, N))
    wt, rt = _t([[1.0, 0.3], [-0.4, 0.8]], [0.05, 0.08])
    h = T.ssm_blocks(tl, tp, dtt[:1])[3]
    hq = torch.stack([h, 0.5 * h])
    return (it, wt, hq, rt), T._rows_hr(it, (wt, hq, rt))


def test_chunked_nll_equals_the_plain_scan():
    """The chunked NLL (a chunk of 8 over 15 rows: pads in the last block)
    equals the plain scan in every form — sliced, blocks built on the fly,
    the quad/logdet split, per-row emissions by index and by payload — and
    so does its gradient through the recomputed blocks."""
    with floatx("float64"):
        _, _, _, y, tl, params, dt = _filter_inputs()
        obs = np.random.default_rng(2).uniform(size=N) > 0.15
        tp = {k: torch.as_tensor(np.asarray(v)).requires_grad_(True) for k, v in params.items()}
        dtt, yt, obst = _t(dt, y, obs)
        used = [v for k, v in tp.items() if "_Noise_" not in k and "_Bias_" not in k]
        a, q, pinf, h = T.ssm_blocks(tl, tp, dtt)
        r = torch.tensor(0.05, dtype=torch.float64)
        plain = T.parallel_kalman_nll(a, q, h, r, yt, obst)[0]
        chunked = T.chunked_kalman_nll(a, q, h, r, yt, obst, chunk=8)
        assert_close(chunked, plain, "float64")
        assert_close(torch.autograd.grad(chunked, used, retain_graph=True),
                     torch.autograd.grad(plain, used, retain_graph=True), "float64")
        fn = lambda d: T.ssm_blocks(tl, tp, d, stationary_first=False)[:2]  # noqa: E731
        on_the_fly = T.chunked_kalman_nll(None, None, h, r, yt, obst, chunk=8, blocks_fn=fn,
                                          dt=dtt, pinf=pinf)
        assert_close(on_the_fly, plain, "float64")
        assert_close(torch.autograd.grad(on_the_fly, used, retain_graph=True),
                     torch.autograd.grad(plain, used, retain_graph=True), "float64")
        assert_close(T.chunked_kalman_nll(a, q, h, r, yt, obst, chunk=8, split=True),
                     T.parallel_kalman_quad_logdet(a, q, h, r, yt, obst), "float64")
        rows, (h_rows, r_rows) = _per_row(tl, tp, dtt)
        plain_rows = T.parallel_kalman_nll(a, q, h_rows, r_rows, yt, obst)[0]
        assert_close(T.chunked_kalman_nll(a, q, None, None, yt, obst, chunk=8, rows=rows),
                     plain_rows, "float64")
        idx_payload = rows[0][None, :].to(torch.float64)     # (k=1, n)
        payload = T.chunked_kalman_nll(
            None, None, None, None, yt, obst, chunk=8, blocks_fn=fn, dt=dtt, pinf=pinf,
            rows=(idx_payload, lambda pb: T._rows_hr(pb[0].round().to(torch.int64), rows[1:])))
        assert_close(payload, plain_rows, "float64")


def test_chunked_smoother_equals_the_plain_smoother():
    with floatx("float64"), torch.no_grad():
        _, _, _, y, tl, params, dt = _filter_inputs()
        obs = np.random.default_rng(3).uniform(size=N) > 0.15
        tp = _tp(params)
        dtt, yt, obst = _t(dt, y, obs)
        a, q, pinf, h = T.ssm_blocks(tl, tp, dtt)
        r = torch.tensor(0.05, dtype=torch.float64)
        rows, (h_rows, r_rows) = _per_row(tl, tp, dtt)
        fn = lambda d: T.ssm_blocks(tl, tp, d, stationary_first=False)[:2]  # noqa: E731
        for hh, rr, kw in ((h, r, {}), (h, r, dict(blocks_fn=fn, dt=dtt, pinf=pinf)),
                           (h_rows, r_rows, dict(rows=rows))):
            m_f, p_f = T.parallel_kalman_filter(a, q, hh, rr, yt, obst)
            m_s, p_s = T.parallel_smoother(a, q, m_f, p_f)
            hb = hh.expand(m_s.shape)
            want = ((m_s * hb).sum(-1), ((p_s @ hb[..., None])[..., 0] * hb).sum(-1))
            a_in, q_in = (None, None) if "blocks_fn" in kw else (a, q)
            h_in, r_in = (None, None) if "rows" in kw else (hh, rr)
            assert_close(T.chunked_smoother_diag(a_in, q_in, h_in, r_in, yt, obst, chunk=8,
                                                 **kw), want, "float64", err_msg=str(kw.keys()))


def test_sharded_programs_name_item_16():
    for fn in (T.sharded_ssm_nll, T.sharded_ssm_nll_multi, T.sharded_ssm_nll_payload,
               T.sharded_ssm_laplace):
        with pytest.raises(NotImplementedError, match="item 16"):
            fn()


def test_leaf_errors_name_the_part():
    t, _ = _series(8)
    with pytest.raises(ValueError, match="state-space"):
        T.ssm_leaves(g3t.LIN(t))
    with pytest.raises(ValueError, match="ARD_L2"):
        T.ssm_leaves(g3t.MAT32(t, metric=g3t.ARD_L1))
    assert jax.config.read("jax_enable_x64") is False
