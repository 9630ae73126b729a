"""Port parity of the linear model of coregionalization
(``g3py_tpu_torch/models/lmc.py``) against the JAX package: the row format
helpers, the hyper names and defaults, the ELBO and its gradient, the
moment statistics (posterior and prior, with and without noise, the
covariance, the log predictive), the host sampler and quantiles from the
same numpy Generator, ``task_correlations``, ``fit_svgp`` with the JAX
package's minibatch indices injected and the predictor, for one shared
kernel and for one kernel a latent, in float64 at 1e-10; the
``lmcsvp_elbo`` pin of ``golden_families.json`` in float32 at
``test_golden_families.py``'s own 5e-5; and the launches of a params dict
of rows: one K1 call a gram (Kuu, Kuf: the latents' grams of one K1 family
are one call) and one K2 call for every Kuu of every row and latent."""

import json
import os

import numpy as np
import pytest
from jax import random

import g3py_tpu as g3
from g3py_tpu.models import lmc as jlmc
import g3py_tpu_torch as g3t

from torch_parity import KernelSpy, assert_close, floatx, jax_logp_dlogp

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_families.json")


def _series(n, seed, span=10.0):
    """``tests/test_golden_families.py``'s series."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, n)).reshape(-1, 1).astype(np.float32)
    y = (np.sin(t[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return t, y


def test_golden_lmcsvp_pin_on_the_port():
    with open(GOLDEN) as fh:
        want = json.load(fh)
    t0, y0 = _series(30, seed=2)
    t1, y1 = _series(25, seed=3)
    xl, yl = g3t.stack_outputs([t0, t1], [y0, 0.7 * y1])
    lmc = g3t.LMCSVP(space=xl, kernel=g3t.SE(t0), outputs_dim=2, inducing=8, name="GOLD_LMC")
    lmc.observed(xl, yl)
    np.testing.assert_allclose(lmc.logp(), want["lmcsvp_elbo"], rtol=5e-5, atol=5e-5)


def _data():
    rng = np.random.default_rng(4)
    x0 = np.sort(rng.uniform(0.0, 6.0, 18))[:, None]
    x1 = np.sort(rng.uniform(0.0, 6.0, 14))[:, None]
    y0 = np.sin(x0[:, 0]) + 0.1 * rng.standard_normal(18)
    y1 = -0.6 * np.sin(x1[:, 0]) + 0.4 + 0.1 * rng.standard_normal(14)
    return x0, x1, y0, y1


def _build(shared, second="MAT52"):
    x0, _, _, _ = _data()

    def build(lib):
        kernel = lib.SE(x0) if shared else [lib.SE(x0, name="KA"),
                                            getattr(lib, second)(x0, name="KB")]
        return lib.LMCSVP(space=lib.with_output(x0[:5], 1), location=lib.Bias(), kernel=kernel,
                          outputs_dim=2, latents=2, inducing=np.linspace(0.3, 5.7, 5)[:, None],
                          name="LMC%d" % shared)

    return build


def _q_params(params, seed=1):
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(v) for k, v in params.items()}
    for k, v in params.items():
        if k.endswith("_qm") or k.endswith("_ql"):
            out[k] = 0.2 * rng.standard_normal(np.shape(v))
    return out


@pytest.mark.parametrize("shared", [True, False])
def test_lmc_matches_jax(shared):
    x0, x1, y0, y1 = _data()
    assert_close(g3t.stack_outputs([x0, x1], [y0, y1]), jlmc.stack_outputs([x0, x1], [y0, y1]),
                 "float64")
    with floatx("float64"):
        x, y = g3t.stack_outputs([x0, x1], [y0, y1])
        xq = g3t.with_output(np.linspace(-0.2, 6.2, 5)[:, None], 1)
        xq = np.concatenate([xq, g3t.with_output(np.array([[1.0], [3.0]]), 0)])
        jp, tp = _build(shared)(g3), _build(shared)(g3t)
        jp.observed(x, y)
        tp.observed(x, y)
        assert [p.name for p in tp.active.ordered_params] == \
            [p.name for p in jp.active.ordered_params]
        assert_close(dict(tp.params_default),
                     {k: np.asarray(v) for k, v in jp.params_default.items()}, "float64")
        params = _q_params(jp.params_default)
        logp, dlogp = jax_logp_dlogp(jp, params)
        assert_close(tp.logp(params), logp, "float64")
        assert_close(tp.dlogp(params), dlogp, "float64")
        yq = np.linspace(-1.0, 1.0, len(xq))
        for prior in (False, True):
            for name, kw in (("mean", {}), ("variance", {}), ("variance", dict(noise=True)),
                             ("covariance", dict(noise=True)), ("location", {}),
                             ("kernel_diag", {})):
                assert_close(getattr(tp, name)(params, xq, prior=prior, **kw),
                             getattr(jp, name)(params, xq, prior=prior, **kw), "float64",
                             err_msg=f"{name} {kw} prior={prior}")
        assert_close(tp.logpredictive(params, xq, vector=yq),
                     jp.logpredictive(params, xq, vector=yq), "float64")
        assert_close(tp.sampler(params, xq, samples=3, noise=True, rng=np.random.default_rng(2)),
                     jp.sampler(params, xq, samples=3, noise=True, rng=np.random.default_rng(2)),
                     "float64")
        assert_close(tp.quantiler(params, xq, q=0.8, noise=True),
                     jp.quantiler(params, xq, q=0.8, noise=True), "float64")
        assert_close(tp.task_correlations(params), jp.task_correlations(params), "float64")
        pr = tp.predictor(params)(xq)
        assert_close(pr["mean"], jp.mean(params, xq), "float64")
        with pytest.raises(ValueError):
            tp.predict_proba(params, xq)


def test_lmc_fit_svgp_matches_jax():
    """Adam over the hypers, q and the mixing, the JAX package's minibatch
    draws injected: the loss trajectory at 1e-8."""
    x0, x1, y0, y1 = _data()
    steps, bs = 8, 10
    with floatx("float64"):
        x, y = g3t.stack_outputs([x0, x1], [y0, y1])
        keys = random.split(random.PRNGKey(3), steps)
        idx = np.stack([np.asarray(random.randint(k, (bs,), 0, len(x))) for k in keys])
        jp, tp = _build(True)(g3), _build(True)(g3t)
        jp.observed(x, y)
        tp.observed(x, y)
        _, lj = jp.fit_svgp(batch_size=bs, steps=steps, lr=0.02, key=3, display=False)
        _, lt = tp.fit_svgp(batch_size=bs, steps=steps, lr=0.02, key=idx, display=False)
        np.testing.assert_allclose(lt, np.asarray(lj), rtol=1e-8)


@pytest.mark.parametrize("shared,second,k1", [(True, "SE", 2), (False, "SE", 2),
                                              (False, "MAT52", 4)])
def test_lmc_rows_are_one_batched_call(shared, second, k1, monkeypatch):
    """R rows: one K1 call a gram (Kuu, Kuf) for a shared kernel or
    latents of one K1 family (one a latent for mixed families), one K2
    call for the R x Q (or R) Kuu, and each row's logp and gradient equal
    to its own."""
    x0, x1, y0, y1 = _data()
    with floatx("float64"):
        x, y = g3t.stack_outputs([x0, x1], [y0, y1])
        tp = _build(shared, second)(g3t)
        tp.observed(x, y)
        reg = tp.active
        u = reg.dict_to_array(_q_params(tp.params_default))
        rows = u[None, :] + 0.05 * np.random.default_rng(0).standard_normal((4, len(u)))
        spy = KernelSpy(monkeypatch)
        lr = tp.logp_chain(rows)
        assert spy.take() == (k1, 1)
        np.testing.assert_allclose(lr, [tp.logp(r, array=True) for r in rows], rtol=1e-10)
        spy.take()
        value, grad = tp._rows_value_and_grad(rows)
        assert spy.take() == (k1, 1)
        np.testing.assert_allclose(grad.numpy(), np.stack([tp.dlogp(r) for r in rows]),
                                   rtol=1e-9, atol=1e-9)
