"""Port parity of ``SKIGP`` (``g3py_tpu_torch/models/ski.py``) against the
JAX package in float64 at 1e-10, the JAX package's probes injected: the
fitted inducing grid, logp and dlogp (one program), the posterior mean,
variance and covariance (one fused program), the Predictor's alpha state;
the joint draws against that posterior (a draw scales the normals by the
grams' eigenvectors, whose signs are LAPACK's); the rows on grid nodes,
where SKI is GridGP's exact model; the ``skigp_*`` golden pins at
tests/test_golden_families.py's 5e-5 in float32."""

import json
import os

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import KernelSpy, assert_close, floatx, jax_logp_dlogp, to_numpy
from test_torch_kron import _probes

F64 = "float64"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_families.json")
Q5 = np.stack([np.linspace(0.5, 5.5, 5), np.linspace(-1.5, 1.5, 5)], 1)


def _data(dtype=np.float64):
    xk = np.stack([np.random.default_rng(6).uniform(0, 6, 40),
                   np.random.default_rng(7).uniform(-2, 2, 40)], 1).astype(dtype)
    yk = (np.sin(xk[:, 0]) + 0.1 * np.random.default_rng(8).standard_normal(40)).astype(dtype)
    return xk, yk


def _pair(name="SK"):
    xk, yk = _data()
    out = []
    for lib in (g3, g3t):
        seed = 0 if lib is g3 else _probes(0, 8, 40)
        proc = lib.SKIGP(kernel=[lib.MAT32(xk[:, :1]), lib.SE(xk[:, 1:2])], grid_shape=[12, 10],
                         ski_probes=8, ski_lanczos=20, ski_seed=seed, name=name)
        proc.observed(xk, yk)
        out.append(proc)
    return out


def test_ski_gp_matches_jax():
    with floatx(F64):
        jp, tp = _pair()
        assert tp._geom == pytest.approx(jp._geom)
        for a, b in zip(tp._axes, jp._axes):
            np.testing.assert_allclose(a, b, rtol=1e-12)
        assert [q.name for q in tp.active.ordered_params] == \
            [q.name for q in jp.active.ordered_params]
        p = {k: np.asarray(v) * 1.1 for k, v in jp.params_default.items()}
        specs = {"mean": ("th_mean", {}), "var": ("th_variance", {}),
                 "varn": ("th_variance", {"noise": True}), "cov": ("th_covariance", {}),
                 "pmean": ("th_mean", {"prior": True}), "pvar": ("th_variance", {"prior": True}),
                 "pcov": ("th_covariance", {"prior": True}), "lp": ("th_logpredictive", {})}
        y_q = np.cos(Q5[:, 0])
        value, grad, want = jax_logp_dlogp(jp, p, Q5, specs, vector=y_q)
        assert_close(tp.logp(p), value, F64)
        assert_close(tp.dlogp(p), grad, F64)
        got = to_numpy({k: getattr(tp, th[3:])(p, Q5, vector=y_q, **kw)
                        for k, (th, kw) in specs.items()})
        assert_close(got, want, F64)
        pr = tp.predictor(p)
        assert_close(pr.predict(Q5, mean=True, std=False, var=True)["mean"], want["mean"], F64)


def test_joint_draws_have_the_posterior():
    with floatx(F64):
        tp = _pair("SKD")[1]
        p = tp.params_default
        for prior in (False, True):
            draws = tp.sampler(p, Q5, samples=4000, seed=13, prior=prior)
            mean = to_numpy(tp.mean(p, Q5, prior=prior))
            cov = to_numpy(tp.covariance(p, Q5, prior=prior))
            sd = np.sqrt(np.diagonal(cov))
            assert np.all(np.abs(draws.mean(1) - mean) <= 5 * sd / np.sqrt(4000) + 1e-12)
            np.testing.assert_allclose(np.cov(draws), cov, atol=0.1 * np.max(np.diagonal(cov)))


def test_rows_on_grid_nodes_are_the_exact_grid_model(monkeypatch):
    """Rows on the inducing nodes have one-hot taps: SKI's logp there is
    GridGP's exact one on the same cells (the same probes give the masked
    estimator on the grid, the same operator); one K1 gram an axis."""
    with floatx(F64):
        xk, yk = _data()
        sk = g3t.SKIGP(kernel=[g3t.MAT32(xk[:, :1]), g3t.SE(xk[:, 1:2])], grid_shape=[12, 10],
                       ski_seed=_probes(0, 8, 60), name="SKN")
        sk.observed(xk, yk)
        a0, a1 = sk._axes[0][:, 0], sk._axes[1][:, 0]
        rng = np.random.default_rng(14)
        cells = rng.choice(120, 60, replace=False)
        rows = np.stack([a0[cells // 10], a1[cells % 10]], 1)
        y = np.sin(rows[:, 0]) + 0.1 * rng.standard_normal(60)
        pick = lambda v: v.reshape(-1, 1)  # noqa: E731
        grid = g3t.GridGP(axes=[a0, a1], kernel=[g3t.MAT32(pick(a0)), g3t.SE(pick(a1))],
                          masked_seed=_probes(0, 8, 60), name="SKG")
        grid.observed(rows, y)
        sk._fit_grid = lambda x: None            # keep the node grid
        sk.observed(rows, y)
        p = {k.replace("SKG", "SKN"): v for k, v in grid.params_default.items()}
        pg = grid.params_default
        np.testing.assert_allclose(sk.logp(p), grid.logp(pg), rtol=1e-9)
        spy = KernelSpy(monkeypatch)
        sk.logp(p)
        assert spy.take() == (2, 0)
        with pytest.raises(NotImplementedError, match="item 16"):
            sk.nll_distributed(p)


@pytest.mark.parametrize("pin", ["skigp_logp", "skigp_dlogp_norm"])
def test_ski_pins_hold_on_port(pin):
    with open(GOLDEN) as fh:
        gold = json.load(fh)
    xk, yk = _data(np.float32)
    sk = g3t.SKIGP(kernel=[g3t.MAT32(xk[:, :1]), g3t.SE(xk[:, 1:2])], grid_shape=[12, 10],
                   ski_probes=8, ski_lanczos=20, ski_seed=_probes(0, 8, 40), name="GOLD_SKI")
    sk.observed(xk, yk)
    got = sk.logp() if pin == "skigp_logp" else float(np.linalg.norm(sk.dlogp()))
    np.testing.assert_allclose(got, gold[pin], rtol=5e-5, atol=5e-5)
