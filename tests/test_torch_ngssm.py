"""Port parity of ``NonGaussianSSGP`` (``g3py_tpu_torch/models/ngssm.py``)
against the JAX package in float64 at 1e-10: the hyper names and defaults,
the Laplace evidence and its gradient for Poisson, Bernoulli and Student-t
observations, the statistics through the likelihood, the joint draws fed
the JAX package's normals, the gaussian identity with ``StateSpaceGP``, the
chunked Newton passes against the plain ones, the rows, and the ``ngssm_*``
golden pins.  The JAX side is live: the three evidences, their gradients
and the statistics are one program compiled with
``torch_parity.FAST_COMPILE`` (``torch_parity.jax_parts``), the draws
their own."""

import json
import os

import numpy as np
import pytest
import torch
from scipy import stats

import g3py_tpu as g3
import g3py_tpu_torch as g3t

import laplace_workloads as W
from torch_parity import (assert_close, floatx, jax_compiled_method, jax_parts, logp_dlogp_part,
                          to_numpy)
from test_torch_statespace import chunked, jax_normals

F64 = "float64"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_families.json")


#: the statistics through the likelihood held to the JAX package's: mean
#: (the rate), variance with and without noise and the Gauss-Hermite log
#: predictive, posterior and prior; the latent location and variance
STATS = {f"{key}{prior}": (th, dict(kw, prior=prior)) for prior in (False, True)
         for key, th, kw in (("mean", "th_mean", {}), ("var", "th_variance", {}),
                             ("varn", "th_variance", {"noise": True}),
                             ("lp", "th_logpredictive", {}))}
STATS.update(loc=("th_location", {}), kd=("th_kernel_diag", {}))

_JAX = {}


def jax_side(kind):
    """The JAX package's (value, grad) of each likelihood's workload at its
    nudged params, and for Poisson its :data:`STATS` at ``NG_TQ``: one
    program for the three (``torch_parity.jax_parts``), computed once a
    process."""
    if not _JAX:
        parts = {}
        for k in ("poisson", "bernoulli", "studentt"):
            jp = W.ngssgp(g3, k)
            p = W.nudged(jp.params_default)
            parts[k] = (logp_dlogp_part(jp, p, W.NG_TQ, STATS, vector=W.NG_YQ)
                        if k == "poisson" else logp_dlogp_part(jp, p))
        _JAX.update(jax_parts(parts))
    return _JAX[kind]


@pytest.mark.parametrize("kind", ["poisson", "bernoulli", "studentt"])
def test_evidence_and_gradient_match_jax(kind):
    """The Laplace evidence and its gradient through the fixed Newton
    iterations; the names and defaults.  Student-t's negative curvature is
    clamped at 1e-6 (W's clip): its gradient goes through the clip's bounds
    as JAX's does."""
    with floatx(F64):
        jp, tp = W.ngssgp(g3, kind), W.ngssgp(g3t, kind)
        assert [q.name for q in tp.active.ordered_params] == \
            [q.name for q in jp.active.ordered_params]
        assert_close(dict(tp.params_default),
                     {k: np.asarray(v) for k, v in jp.params_default.items()}, F64)
        p = W.nudged(jp.params_default)
        value, grad = jax_side(kind)[:2]
        assert_close(tp.logp(p), value, F64)
        assert_close(tp.dlogp(p), grad, F64)


def test_statistics_match_jax():
    """The posterior and prior statistics through the likelihood: mean
    (the rate), variance with and without noise, the Gauss-Hermite log
    predictive, the latent location and variance; the quantiles from the
    port's own moments; no median for a count likelihood."""
    tq, y_q = W.NG_TQ, W.NG_YQ
    with floatx(F64):
        tp = W.ngssgp(g3t, "poisson")
        p = W.nudged(tp.params_default)
        want = jax_side("poisson")[2]
        got = {k: getattr(tp, th[3:])(p, tq, vector=y_q, **kw) for k, (th, kw) in STATS.items()}
        assert_close(got, want, F64)
        assert_close(tp.quantiler(p, tq, q=0.9),
                     np.exp(stats.norm.ppf(0.9, loc=want["loc"], scale=np.sqrt(want["kd"]))), F64)
        with pytest.raises(NotImplementedError):
            tp.median(p, tq)


def test_joint_draws_from_the_jax_normals():
    """The simulation smoother on the pseudo-model at the mode and the prior
    paths, fed the JAX package's normals (its key splits of seeds 3 and 5);
    ``noise=True`` draws integer counts."""
    tq = W.NG_DRAW_TQ
    with floatx(F64):
        jp, tp = W.ngssgp(g3, "poisson"), W.ngssgp(g3t, "poisson")
        p = W.nudged(jp.params_default, seed=2)
        jax_compiled_method(jp, "_joint_draws")
        want = (jp.sampler(p, tq, samples=2, seed=3),
                jp.sampler(p, tq, samples=2, prior=True, seed=5))
        post = jax_normals(3, 2, len(jp.inputs) + len(tq), 2)
        assert_close(tp.sampler(p, tq, samples=2, seed=post), want[0], F64)
        prior = jax_normals(5, 2, len(tq), 2, prior=True)
        assert_close(tp.sampler(p, tq, samples=2, prior=True, seed=prior), want[1], F64)
        counts = tp.sampler(p, tq, samples=2, seed=post, noise=True,
                            rng=np.random.default_rng(9))
        assert counts.shape == (len(tq), 2) and np.all(counts == np.round(counts))
        assert tp.sampler(p, tq, samples=3, seed=0).shape == (len(tq), 3)


def _like_grad(proc, p):
    """The loglike and its gradient in the natural params (autograd)."""
    pt = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True) for k, v in p.items()}
    val = proc._logp_pure(like_only=True)(pt, *proc._resolve_data(None, None, None))
    grads = torch.autograd.grad(val, list(pt.values()))
    return float(val.detach()), {k: g.numpy() for k, g in zip(pt, grads)}


def test_gaussian_identity_with_statespace_gp():
    """With GaussianLik the mode is one Newton step and the evidence is
    StateSpaceGP's exact one (the module docstring's identity), its gradient
    and statistics too, within 1e-7: the Laplace quadratic term assumes the
    exact mode, so the smoother's float64 rounding (~1e-9 of the mean)
    enters it at first order."""
    t, ys = W.counts(n=40)
    y = ys["studentt"]
    with floatx(F64):
        ss = g3t.StateSpaceGP(space=t, kernel=g3t.MAT32(t) + g3t.OU(t), name="ID")
        ng = g3t.NonGaussianSSGP(space=t, kernel=g3t.MAT32(t) + g3t.OU(t),
                                 likelihood=g3t.GaussianLik(), name="ID")
        ss.observed(t, y)
        ng.observed(t, y)
        p = W.nudged(ss.params_default, seed=4)
        pn = {k: v for k, v in p.items() if not k.endswith("Noise_var")}
        pn["ID_GaussLik_var"] = p["ID_Noise_var"]
        vs, gs = _like_grad(ss, p)
        vn, gn = _like_grad(ng, pn)
        gn["ID_Noise_var"] = gn.pop("ID_GaussLik_var")
        np.testing.assert_allclose(vn, vs, rtol=1e-7)
        for k in gs:
            np.testing.assert_allclose(gn[k], gs[k], rtol=1e-6, atol=1e-7, err_msg=k)
        tq = np.linspace(0, 10, 6)[:, None]
        np.testing.assert_allclose(to_numpy(ng.location(pn, tq)), to_numpy(ss.location(p, tq)),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(to_numpy(ng.variance(pn, tq, noise=True)),
                                   to_numpy(ss.variance(p, tq, noise=True)), rtol=1e-7)


def test_chunked_newton_passes_equal_the_plain_ones(monkeypatch):
    """Past ssm_chunk_threshold every Newton pass, the evidence and the
    smoother run as the payload-form chunked scans: the same numbers (5
    Newton steps on both sides)."""
    monkeypatch.setattr(g3t.settings, "ssm_laplace_iters", 5)
    with floatx(F64):
        tp = W.ngssgp(g3t, "poisson", n=40)
        p = W.nudged(tp.params_default, seed=5)
        tq = np.linspace(0, 10, 6)[:, None]
        plain = (tp.logp(p), tp.dlogp(p), to_numpy(tp.mean(p, tq)))
        with chunked(threshold=30, chunk=16):
            assert_close((tp.logp(p), tp.dlogp(p), to_numpy(tp.mean(p, tq))), plain, F64)


def test_rows_are_one_batched_loop(monkeypatch):
    """A params dict of rows is one Newton loop over (R, n): each row equals
    its single evaluation (5 Newton steps)."""
    monkeypatch.setattr(g3t.settings, "ssm_laplace_iters", 5)
    with floatx(F64):
        tp = W.ngssgp(g3t, "bernoulli", n=20)
        u = tp.active.dict_to_array(tp.params_default)
        rows = u[None] + 0.1 * np.random.default_rng(6).standard_normal((3, len(u)))
        val, grad = tp._rows_value_and_grad(torch.as_tensor(rows))
        for i in range(3):
            v1, g1 = tp._rows_value_and_grad(torch.as_tensor(rows[i]))
            assert_close(val[i], v1, F64)
            assert_close(grad[i], g1, F64)


def _gold_series(n, seed, span=10.0):
    """tests/test_golden_families.py's series (float32)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, n)).reshape(-1, 1).astype(np.float32)
    return t, (np.sin(t[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("pin", ["ngssm_poisson_logp", "ngssm_mean_sum"])
def test_golden_pins_hold_on_port(pin):
    """tests/golden_families.json's NonGaussianSSGP pins on
    tests/test_golden_families.py's workload (the first draw of its rng(99)
    stream), at its 5e-5; the sharded objective raises citing item 16."""
    with open(GOLDEN) as f:
        gold = json.load(f)
    rng = np.random.default_rng(99)
    t4, _ = _gold_series(40, seed=8)
    y4 = rng.poisson(np.exp(0.8 * np.sin(t4[:, 0]))).astype(np.float32)
    ng = g3t.NonGaussianSSGP(space=t4, kernel=g3t.MAT32(t4), likelihood=g3t.PoissonLik(),
                             name="GOLD_NG")
    ng.observed(t4, y4)
    got = {"ngssm_poisson_logp": lambda: ng.logp(),
           "ngssm_mean_sum": lambda: float(np.sum(to_numpy(ng.mean(space=t4[::5]))))}[pin]()
    np.testing.assert_allclose(got, gold[pin], rtol=5e-5, atol=5e-5)
    with pytest.raises(NotImplementedError, match="item 16"):
        ng.nll_distributed(ng.params)
