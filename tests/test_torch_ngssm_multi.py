"""Port parity of ``NonGaussianMultiSSGP`` (``g3py_tpu_torch/models/
ngssm.py``) against the JAX package: the hyper names (a repeated likelihood
class suffixed by position) and defaults, live; the Laplace evidence and
its gradient over Poisson + Bernoulli channels and the statistics through
each row's channel likelihood, from one program of the JAX package computed
once (``torch_parity.jax_logp_dlogp``; float64 at 1e-10, the port's float32 at
rtol 1e-4 / atol 1e-5); the chunked payload form against the plain scans;
and a case where the JAX package's program at XLA's default optimization
level gave a gradient ~10% off its own central differences (ROADMAP Queue
3): its program compiled with ``FAST_COMPILE``, the port's and the
differences agree."""

import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t

import laplace_workloads as W
from torch_parity import assert_close, floatx, jax_logp_dlogp, to_numpy
from test_torch_statespace import chunked

F64 = "float64"


@pytest.mark.parametrize("shared", [False, True])
def test_names_and_defaults_match_jax(shared):
    """A shared likelihood or one a channel, repeated classes suffixed."""
    t0, t1, y0, y1 = W.ngm_data("mixed")
    with floatx(F64):
        procs = []
        for lib in (g3, g3t):
            x, y = lib.stack_outputs([t0, t1], [y0, y0[:len(t1)] if shared else y1])
            lik = lib.PoissonLik() if shared else [lib.PoissonLik(), lib.PoissonLik()]
            proc = lib.NonGaussianMultiSSGP(space=x, kernel=[lib.MAT32(t0, name="KA"),
                                                             lib.OU(t0, name="KB")],
                                            likelihood=lik, outputs_dim=2, name="NM%d" % shared)
            proc.observed(x, y)
            procs.append(proc)
        jp, tp = procs
        assert [q.name for q in tp.active.ordered_params] == \
            [q.name for q in jp.active.ordered_params]
        assert_close(dict(tp.params_default),
                     {k: np.asarray(v) for k, v in jp.params_default.items()}, F64)


#: the statistics through each row's channel likelihood
STATS = {"mean": ("th_mean", {}), "var": ("th_variance", {}),
         "varn": ("th_variance", {"noise": True}), "lp": ("th_logpredictive", {})}
_JAX = {}


def _params(proc):
    return {k: np.asarray(v) * 1.1 + 0.05 for k, v in proc.params_default.items()}


def jax_side():
    """The JAX package's evidence, gradient and :data:`STATS` at
    ``NGM_XQ`` of the 20 + 14 workload: one program, computed once a
    process and shared by the two tests that read it."""
    if not _JAX:
        jp = W.ngmssgp(g3, "fault")
        _JAX["fault"] = jax_logp_dlogp(jp, _params(jp), W.NGM_XQ, STATS, vector=W.NGM_YQ)
    return _JAX["fault"]


def test_evidence_gradient_and_statistics_match_jax():
    xq, y_q = W.NGM_XQ, W.NGM_YQ
    with floatx(F64):
        jp, tp = W.ngmssgp(g3, "fault"), W.ngmssgp(g3t, "fault")
        assert [q.name for q in tp.active.ordered_params] == \
            [q.name for q in jp.active.ordered_params]
        p = _params(jp)
        value, grad, want = jax_side()
        assert_close(tp.logp(p), value, F64)
        assert_close(tp.dlogp(p), grad, F64)
        got = {"mean": tp.mean(p, xq), "var": tp.variance(p, xq),
               "varn": tp.variance(p, xq, noise=True),
               "lp": tp.logpredictive(p, xq, vector=y_q)}
        assert_close(got, want, F64)
        with pytest.raises(NotImplementedError):
            tp.median(p, xq)
    with floatx("float32"):
        tp = W.ngmssgp(g3t, "fault")
        assert_close(tp.logp(p), value, "float32")
        assert_close(tp.dlogp(p), grad, "float32")


def test_gradient_matches_jax_and_central_differences():
    """20 + 14 rows: the values agree at 1e-10; the port's gradient equals
    the JAX package's (compiled with FAST_COMPILE) at 1e-10 and central
    differences of the logp to 1e-6 (ROADMAP Queue 3: at XLA's default
    optimization the JAX package's gradient is ~10% off them here)."""
    with floatx(F64):
        tp = W.ngmssgp(g3t, "fault")
        p = _params(tp)
        value, jgrad = jax_side()[:2]
        assert_close(tp.logp(p), value, F64)
        u = tp.active.dict_to_array(p)
        fd = np.array([(tp.logp(u + e, array=True) - tp.logp(u - e, array=True)) / 2e-5
                       for e in 1e-5 * np.eye(len(u))])
        grad = tp.dlogp(p)
        np.testing.assert_allclose(grad, fd, rtol=1e-6, atol=1e-6)
        assert_close(grad, jgrad, F64)


def test_chunked_payload_equals_the_plain_scans(monkeypatch):
    """Past ssm_chunk_threshold the Newton passes, the evidence and the
    smoother carry (channel index, pseudo-noise) in the chunked payload (5
    Newton steps on both sides)."""
    monkeypatch.setattr(g3t.settings, "ssm_laplace_iters", 5)
    with floatx(F64):
        tp = W.ngmssgp(g3t, "mixed")
        p = {k: np.asarray(v) * 1.1 + 0.05 for k, v in tp.params_default.items()}
        plain = (tp.logp(p), tp.dlogp(p), to_numpy(tp.variance(p, W.NGM_XQ)))
        with chunked(threshold=8, chunk=5):
            assert_close((tp.logp(p), tp.dlogp(p), to_numpy(tp.variance(p, W.NGM_XQ))),
                         plain, F64)


def test_rows_draws_and_errors():
    """A params dict of rows equals its single rows; the draws through each
    row's channel likelihood (counts on channel 0, events on channel 1);
    the constructor's and observed()'s errors; the sharded objective raises
    citing item 16."""
    with floatx(F64):
        tp = W.ngmssgp(g3t, "mixed")
        u = tp.active.dict_to_array(tp.params_default)
        rows = u[None] + 0.05 * np.random.default_rng(7).standard_normal((2, len(u)))
        val, grad = tp._rows_value_and_grad(torch.as_tensor(rows))
        v1, g1 = tp._rows_value_and_grad(torch.as_tensor(rows[1]))
        assert_close((val[1], grad[1]), (v1, g1), F64)
        draws = tp.sampler(tp.params_default, W.NGM_XQ, samples=4, seed=1, noise=True)
        assert np.all(np.isin(draws[W.NGM_XQ[:, 1] == 1], [0.0, 1.0]))
        assert np.all(draws == np.round(draws))
        q = tp.quantiler(tp.params_default, W.NGM_XQ, q=0.5)
        assert np.all((q[W.NGM_XQ[:, 1] == 1] > 0) & (q[W.NGM_XQ[:, 1] == 1] < 1))
        with pytest.raises(NotImplementedError, match="item 16"):
            tp.nll_distributed(tp.params)
    t0, t1, y0, y1 = W.ngm_data("mixed")
    x, y = g3t.stack_outputs([t0, t1], [y0, y1])
    with pytest.raises(ValueError, match="likelihood list"):
        g3t.NGMSSGP(space=x, kernel=g3t.MAT32(t0), outputs_dim=3,
                    likelihood=[g3t.PoissonLik(), g3t.BernoulliLik()], name="E1")
    with pytest.raises(ValueError, match="output indices"):
        g3t.NGMSSGP(space=x, kernel=g3t.MAT32(t0), outputs_dim=1, name="E2").observed(x, y)
