"""``StateSpaceGP`` on the port beyond its parity statistics
(``tests/test_torch_statespace.py``): the chunked routing with
``ssm_chunk_threshold`` lowered in both packages (logp, dlogp, mean and
variance against the JAX package and against the port's plain path, float64
at 1e-10), a params dict of rows against its rows one by one (one scan over
(R, n, s, s)), the predictor (its state the params themselves), the
quasi-periodic kernel against the port's dense ``GP(noisy=True)``,
``find_MAP`` raising the logp, and the errors (no covariance, 1-D inputs,
item 16, item 13b)."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx, jax_logp_dlogp, to_numpy
from test_torch_statespace import F64, _nudged, _pair, _series, _ssgp, chunked


def test_ssgp_chunked_routing_matches_jax_and_the_plain_path():
    """n=28 above a threshold of 12: the loglike takes the chunked NLL (4
    blocks of 8, the last ragged) and the statistics the chunked smoother."""
    t, y = _series(n=28, seed=2)
    tq = np.linspace(0.0, 10.0, 7)[:, None]
    with floatx(F64):
        jp, tp = _pair(_ssgp, t)
        for proc in (jp, tp):
            proc.observed(t, y)
        p = _nudged(jp.params, seed=2)
        plain = (tp.logp(p), tp.dlogp(p), to_numpy(tp.mean(p, tq)),
                 to_numpy(tp.variance(p, tq)))
        with chunked():
            got = (tp.logp(p), tp.dlogp(p), to_numpy(tp.mean(p, tq)),
                   to_numpy(tp.variance(p, tq)))
            value, grad, st = jax_logp_dlogp(jp, p, tq, {"mean": ("th_mean", {}),
                                                         "var": ("th_variance", {})})
            want = (value, grad, st["mean"], st["var"])
        assert_close(got, want, F64)
        assert_close(got, plain, F64)


def test_ssgp_rows_are_one_batched_scan():
    """A params dict of R rows (the sampler's) runs one scan over (R, n, s,
    s): logp_chain and the rows' gradients equal each row's own."""
    t, y = _series(n=40, seed=3)
    with floatx(F64):
        tp = _ssgp(g3t, t)
        tp.observed(t, y)
        u0 = tp.active.dict_to_array(tp.params)
        rows = u0[None, :] + 0.2 * np.random.default_rng(0).standard_normal((4, len(u0)))
        chain = tp.logp_chain(rows)
        value, grad = tp._rows_value_and_grad(rows)
        for i, u in enumerate(rows):
            assert_close(chain[i], tp.logp(u, array=True), F64)
            assert_close(to_numpy(value[i]), tp.logp(u, array=True), F64)
            assert_close(to_numpy(grad[i]), tp.dlogp(u), F64)


def test_ssgp_predictor_and_dense_exactness():
    """The Predictor's batches are the statistics (its state is {}); the
    quasi-periodic kernel's NLL is the dense GP's to the harmonics'
    truncation."""
    t, y = _series(n=36, seed=5)
    tq = np.linspace(0.5, 9.5, 9)[:, None]
    with floatx(F64):
        tp = _ssgp(g3t, t, "quasi")
        tp.observed(t, y)
        p = _nudged(tp.params, seed=4)
        assert tp.posterior_state(p) == {}
        got = tp.predictor(p).predict(tq, mean=True, std=True, var=True)
        assert_close(got["mean"], tp.mean(p, tq), F64)
        assert_close(got["variance"], tp.variance(p, tq), F64)
        assert_close(got["std"], np.sqrt(to_numpy(tp.variance(p, tq))), F64)
        dense = g3t.GP(space=t, location=g3t.Bias(),
                       kernel=g3t.SIN(t) * g3t.MAT52(t) + g3t.COS(t), noisy=True,
                       name="SS_quasi")
        dense.observed(t, y)
        assert set(dense.params) == set(tp.params)
        np.testing.assert_allclose(tp.logp(p), dense.logp(p), rtol=1e-6)
        np.testing.assert_allclose(to_numpy(tp.mean(p, tq)), to_numpy(dense.mean(p, tq)),
                                   atol=1e-5)


def test_ssgp_find_map_improves():
    t, y = _series(n=40, seed=4)
    with floatx(F64):
        tp = _ssgp(g3t, t)
        tp.observed(t, y)
        start = tp.logp(tp.params)
        params = tp.find_MAP(points=1, display=False)
        assert tp.logp(params) > start + 1.0


def test_ssgp_errors():
    t, y = _series(n=16, seed=6)
    tp = _ssgp(g3t, t)
    tp.observed(t, y)
    with pytest.raises(ValueError, match="covariance"):
        tp.covariance(tp.params, t)
    with pytest.raises(NotImplementedError, match="item 16"):
        tp.nll_distributed(tp.params)
    with pytest.raises(ValueError, match="state-space"):
        g3t.StateSpaceGP(space=t, kernel=g3t.LIN(t), name="S_lin")
    x2 = np.concatenate([t, t], axis=1)
    with pytest.raises(ValueError, match="1-D"):
        g3t.StateSpaceGP(space=x2, kernel=g3t.OU(x2[:, :1]), name="S_2d").observed(x2, y)
    # the Laplace family (item 13b) is ported: its names are its classes,
    # and only its time-axis-sharded objective raises (item 16)
    from g3py_tpu_torch.models import ngssm

    for name in ("NonGaussianSSGP", "NGSSGP", "NonGaussianMultiSSGP", "NGMSSGP",
                 "NonGaussianSTSSGP", "NGSTSSGP"):
        assert getattr(g3t, name) is getattr(ngssm, name)
    ng = g3t.NGSSGP(space=t, kernel=g3t.MAT32(t), name="S_ng")
    ng.observed(t, np.round(np.abs(y) * 3))
    with pytest.raises(NotImplementedError, match="item 16"):
        ng.nll_distributed(ng.params)
    assert g3t.SSGP is g3t.StateSpaceGP and g3t.LMCSSGP is g3t.MultiStateSpaceGP
    assert hasattr(g3, "NonGaussianSSGP")
