"""Port parity of ``SparseSpatioTemporalSSGP``
(``g3py_tpu_torch/models/spatiotemporal.py``) against the JAX package in
float64 at 1e-10: rows at free 2-D coordinates, with inducing sites that
cover every observed location (the FITC residual vanishes) and with a
subset of them — logp and dlogp (one program of the JAX package for both
models, computed once), and with ``ssm_chunk_threshold`` lowered the chunked
payload path (each block's emissions from its own cross gram), equal to
the same JAX program's and to the port's plain path;
the statistics at off-site rows against the port's own pieces; the K1/K2
calls an evaluation (one K1 site gram, one K1 (m, n) cross gram, one K2)."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import KernelSpy, assert_close, floatx, jax_parts, logp_dlogp_part, to_numpy
from test_torch_spatiotemporal import F64, SITES, _nudged
from test_torch_statespace import chunked


def scattered_rows(n=20, seed=3):
    """n rows (t, x1, x2) on the 4 locations of ``SITES``, targets from a
    smooth field."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, n))
    loc = SITES[rng.integers(0, len(SITES), n)]
    y = np.sin(t) * np.cos(loc[:, 0]) + 0.3 * loc[:, 1] + 0.1 * rng.standard_normal(n)
    return np.concatenate([t[:, None], loc], axis=1), y


def sparse(lib, inducing, name):
    x, y = scattered_rows()
    st = lib.SparseSpatioTemporalSSGP(space=x, location=lib.Bias(),
                                      kernel=lib.MAT32(x[:, :1]), space_kernel=lib.SE(SITES),
                                      inducing=inducing, name=name)
    st.observed(x, y)
    return st


CASES = {"complete": SITES, "subset": SITES[[0, 2, 3]]}
_JAX = {}


def jax_side(case):
    """The JAX package's logp and dlogp of both cases' models at their
    params nudged by seed 2: one program (``torch_parity.jax_parts``),
    computed once a process (the plain and the chunked routing's checks
    share it)."""
    if not _JAX:
        parts = {}
        for c in CASES:
            jp = sparse(g3, CASES[c], "SP_" + c)
            parts[c] = logp_dlogp_part(jp, _nudged(jp.params, seed=2))
        _JAX.update(jax_parts(parts))
    return _JAX[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_logp_dlogp_match_jax(case):
    with floatx(F64):
        jp, tp = (sparse(lib, CASES[case], "SP_" + case) for lib in (g3, g3t))
        assert [q.name for q in tp.active.ordered_params] == \
            [q.name for q in jp.active.ordered_params]
        for k, v in jp.params_default.items():
            np.testing.assert_array_equal(tp.params_default[k], np.asarray(v), err_msg=k)
        p = _nudged(jp.params, seed=2)
        value, grad = jax_side(case)
        assert_close(tp.logp(p), value, F64)
        assert_close(tp.dlogp(p), grad, F64)
        x = tp._device_data("inputs")
        _, resid = tp._wrows(tp._tensor_params(p), x[:, 1:])
        if case == "complete":                 # Z covers every location
            assert float(resid.abs().max()) < 1e-8
        else:
            assert float(resid.max()) > 1e-4


def test_sparse_chunked_payload_path_matches_jax_and_the_plain_path():
    with floatx(F64):
        jp, tp = (sparse(lib, CASES["subset"], "SP_subset") for lib in (g3, g3t))
        p = _nudged(jp.params, seed=2)
        want = jax_side("subset")
        xq = np.array([[2.0, 0.5, 0.5], [7.5, 1.0, 0.3], [4.0, -1.0, 2.0]])
        plain = (tp.logp(p), tp.dlogp(p), to_numpy(tp.mean(p, xq)),
                 to_numpy(tp.variance(p, xq)))
        with chunked(threshold=12, chunk=8):
            got = (tp.logp(p), tp.dlogp(p), to_numpy(tp.mean(p, xq)),
                   to_numpy(tp.variance(p, xq)))
        assert_close(got[:2], want, F64)
        assert_close(got, plain, F64)


def test_sparse_statistics_and_kernel_calls(monkeypatch):
    """Off-site rows: the posterior variance is the projection's plus the
    row's FITC residual, the prior the projected stationary variance plus
    it; one evaluation is K1 x2 (site gram, cross gram) and K2 x1."""
    with floatx(F64):
        tp = sparse(g3t, CASES["subset"], "SP_stats")
        p = _nudged(tp.params, seed=4)
        xq = np.array([[2.0, 0.5, 0.5], [7.5, 1.0, 0.3], [4.0, -1.0, 2.0]])
        pt = tp._tensor_params(p)
        wq, resid = tp._wrows(pt, g3t.config.as_tensor(xq[:, 1:]))
        m, v = tp._run_smoother_weights(pt, g3t.config.as_tensor(xq[:, 0]), wq,
                                        tp._device_data("inputs"), tp._device_data("outputs"))
        assert_close(tp.variance(p, xq), to_numpy(v + resid), F64)
        loc = to_numpy(tp.f_location(pt, g3t.config.as_tensor(xq[:, :1])))
        assert_close(tp.mean(p, xq), to_numpy(m) + loc, F64)
        assert np.all(to_numpy(tp.variance(p, xq, prior=True)) >= to_numpy(resid) - 1e-12)
        spy = KernelSpy(monkeypatch)
        tp.logp(p)
        assert spy.take() == (2, 1)
        tp.dlogp(p)
        assert spy.take() == (2, 1)
        draws = tp.sampler(p, xq, samples=5, seed=1)
        assert draws.shape == (3, 5) and np.isfinite(draws).all()
