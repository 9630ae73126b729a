"""Port parity of ``MultiStateSpaceGP`` (``g3py_tpu_torch/models/
statespace.py``) against the JAX package in float64 at 1e-10: the hyper
names and defaults, logp and dlogp (one kernel a latent and one shared
kernel), the moment statistics at rows of both outputs (posterior and
prior, with and without noise, the log predictive), ``task_correlations``,
the prior sampler fed the JAX package's normals and the posterior sampler's
draws against the smoother's moments, the chunked routing with
``ssm_chunk_threshold`` lowered (held to the same JAX program as the plain
path), and a params dict of rows against its rows one by one.  The JAX
side's logp, dlogp and statistics are one program for both models
(``torch_parity.jax_parts``), computed once and shared by the tests that
read it."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import (assert_close, floatx, jax_compiled_method, jax_parts, logp_dlogp_part,
                          to_numpy)
from test_torch_statespace import (F64, STATS, _mssgp, _nudged, _pair, _stats,
                                   assert_names_and_defaults, assert_port_quantities, chunked,
                                   jax_normals)


def _queries():
    tq = np.linspace(0.0, 8.5, 6)[:, None]
    return np.concatenate([g3t.with_output(tq, 0), g3t.with_output(tq, 1)])


_JAX = {}


def jax_side(shared):
    """The JAX package's logp and dlogp of both models (one kernel a latent,
    one shared) at their params nudged by seed 5, and the first's
    :data:`STATS` at :func:`_queries`: one program
    (``torch_parity.jax_parts``), computed once a process and shared by the
    plain and the chunked routing's checks."""
    if not _JAX:
        xq, parts = _queries(), {}
        for sh in (False, True):
            jp = _mssgp(g3, sh)[0]
            p = _nudged(jp.params, seed=5)
            parts[sh] = (logp_dlogp_part(jp, p) if sh else
                         logp_dlogp_part(jp, p, xq, STATS, vector=np.sin(xq[:, 0])))
        _JAX.update(jax_parts(parts))
    return _JAX[shared]


@pytest.mark.parametrize("shared", [False, True])
def test_mssgp_logp_dlogp_match_jax(shared):
    with floatx(F64):
        (jp, _, _), (tp, _, _) = _pair(_mssgp, shared)
        assert_names_and_defaults(jp, tp)
        p = _nudged(jp.params, seed=5)
        value, grad = jax_side(shared)[:2]
        assert_close(tp.logp(p), value, F64)
        assert_close(tp.dlogp(p), grad, F64)


def test_mssgp_statistics_and_prior_draws_match_jax():
    with floatx(F64):
        (jp, x, _), (tp, _, _) = _pair(_mssgp, False)
        p = _nudged(jp.params, seed=5)
        xq = _queries()
        y_q = np.sin(xq[:, 0])
        assert_close(_stats(tp, p, xq, y_q), jax_side(False)[2], F64)
        assert_port_quantities(tp, p, xq)
        assert_close(tp.task_correlations(p), jp.task_correlations(p), F64)
        s = sum(leaf.dim for leaves in tp._leaf_sets for leaf in leaves)
        prior = jax_normals(4, 2, len(xq), s, prior=True)
        assert_close(tp.sampler(p, xq, samples=2, prior=True, seed=prior),
                     jax_compiled_method(jp, "_joint_draws").sampler(p, xq, samples=2,
                                                                     prior=True, seed=4), F64)
        assert_close(tp.predictor(p).predict(xq)["mean"], tp.mean(p, xq), F64)


def test_mssgp_posterior_draws_have_the_smoother_moments():
    """4000 joint draws (the Matheron simulation smoother on the device's
    generator) against the smoother's mean and variance, the draws' noise
    against each output's own variance."""
    with floatx(F64):
        tp, x, _ = _mssgp(g3t, False)
        p = _nudged(tp.params, seed=7)
        xq = _queries()
        draws = tp.sampler(p, xq, samples=4000, seed=11)
        m, v = to_numpy(tp.mean(p, xq)), to_numpy(tp.variance(p, xq))
        np.testing.assert_allclose(draws.mean(axis=1), m, atol=6 * np.sqrt(v.max() / 4000))
        np.testing.assert_allclose(draws.var(axis=1), v, rtol=0.12, atol=1e-3 * v.max())
        noisy = tp.sampler(p, xq, samples=4000, seed=11, noise=True,
                           rng=np.random.default_rng(0))
        vn = to_numpy(tp.variance(p, xq, noise=True))
        np.testing.assert_allclose(noisy.var(axis=1), vn, rtol=0.12)


def test_mssgp_chunked_routing_and_rows():
    with floatx(F64):
        (jp, x, y), (tp, _, _) = _pair(_mssgp, False)
        p = _nudged(jp.params, seed=5)
        xq = _queries()
        value, grad, st = jax_side(False)
        plain = (tp.logp(p), tp.dlogp(p), to_numpy(tp.mean(p, xq)),
                 to_numpy(tp.variance(p, xq)))
        with chunked():
            got = (tp.logp(p), tp.dlogp(p), to_numpy(tp.mean(p, xq)),
                   to_numpy(tp.variance(p, xq)))
        assert_close(got, (value, grad, st["meanFalse"], st["varFalse"]), F64)
        assert_close(got, plain, F64)
        u0 = tp.active.dict_to_array(p)
        rows = u0[None, :] + 0.1 * np.random.default_rng(2).standard_normal((3, len(u0)))
        value, grad = tp._rows_value_and_grad(rows)
        for i, u in enumerate(rows):
            assert_close(to_numpy(value[i]), tp.logp(u, array=True), F64)
            assert_close(to_numpy(grad[i]), tp.dlogp(u), F64)
    with pytest.raises(ValueError, match="kernel list"):
        g3t.MultiStateSpaceGP(space=x, kernel=[g3t.OU(x[:, :1])] * 3, outputs_dim=2,
                              latents=2)
    with pytest.raises(ValueError, match="output indices"):
        tp.observed(np.stack([x[:, 0], x[:, 1] + 2], axis=1), y)
    with pytest.raises(NotImplementedError, match="item 16"):
        tp.nll_distributed(p)
