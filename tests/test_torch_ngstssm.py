"""Port parity of ``NonGaussianSTSSGP`` (``g3py_tpu_torch/models/ngssm.py``),
the spatio-temporal Poisson Cox process, against the JAX package in float64
at 1e-10: the hyper names and defaults live; the Laplace evidence and its
gradient through the sites' factor and the on-site statistics from one
program of the JAX package (``torch_parity.jax_logp_dlogp``), the off-site
``field`` and ``field_rate`` through its compiled smoother; and
the K1/K2 calls of the plain path (an evaluation one site gram and one
factorization, ``field_rate`` two grams and one factorization), counted by
``torch_parity.KernelSpy``."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

import laplace_workloads as W
from torch_parity import KernelSpy, assert_close, floatx, jax_compiled_method, jax_logp_dlogp

F64 = "float64"


def test_names_and_defaults_match_jax():
    with floatx(F64):
        jp, tp = W.ngstssgp(g3), W.ngstssgp(g3t)
        assert [q.name for q in tp.active.ordered_params] == \
            [q.name for q in jp.active.ordered_params]
        assert_close(dict(tp.params_default),
                     {k: np.asarray(v) for k, v in jp.params_default.items()}, F64)


def test_evidence_field_and_statistics_match_jax():
    with floatx(F64):
        jp, tp = W.ngstssgp(g3), W.ngstssgp(g3t)
        p = {k: np.asarray(v) * 1.1 + 0.05 for k, v in jp.params_default.items()}
        value, grad, want = jax_logp_dlogp(jp, p, W.NGST_ROWS, {"mean": ("th_mean", {}),
                                                                "var": ("th_variance", {})})
        assert_close(tp.logp(p), value, F64)
        assert_close(tp.dlogp(p), grad, F64)
        assert_close({"mean": tp.mean(p, W.NGST_ROWS), "var": tp.variance(p, W.NGST_ROWS)},
                     want, F64)
        jax_compiled_method(jp, "_run_smoother_weights")
        assert_close(tp.field_rate(W.NGST_TQ, W.NGST_XQ, params=p),
                     jp.field_rate(W.NGST_TQ, W.NGST_XQ, params=p), F64)
        assert_close(tp.field(W.NGST_TQ, W.NGST_XQ, params=p),
                     jp.field(W.NGST_TQ, W.NGST_XQ, params=p), F64)


def test_kernel_calls_on_the_plain_path(monkeypatch):
    """An evaluation builds the site gram once (K1) and factors it once
    (K2), the Newton steps reusing the factor; field_rate adds the (m, nq)
    cross gram; the task correlations are the normalized site gram."""
    spy = KernelSpy(monkeypatch)
    tp = W.ngstssgp(g3t)
    p = tp.params_default
    tp.logp(p)
    assert spy.take() == (1, 1)
    tp.dlogp(p)
    assert spy.take() == (1, 1)
    m, v = tp.field_rate(W.NGST_TQ, W.NGST_XQ, params=p)
    assert spy.take() == (2, 1)
    assert np.all(m > 0) and np.all(v > 0)
    c = tp.task_correlations(p)
    np.testing.assert_allclose(np.diagonal(c), 1.0, rtol=1e-6)


def test_constructor_errors():
    sites = W.ngst_sites()
    x = np.array([[0.0, 0.0], [1.0, 1.0]])
    with pytest.raises(ValueError, match="space_kernel"):
        g3t.NGSTSSGP(space=x, kernel=g3t.MAT32(x[:, :1]), name="E1")
    with pytest.raises(ValueError, match="ONE likelihood"):
        g3t.NGSTSSGP(space=x, kernel=g3t.MAT32(x[:, :1]), space_kernel=g3t.SE(sites),
                     sites=sites, likelihood=[g3t.PoissonLik()], name="E2")
