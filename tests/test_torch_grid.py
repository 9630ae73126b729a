"""Port parity of ``GridGP`` and ``grid_rows`` (``g3py_tpu_torch/models/
grid.py``) against the JAX package: complete grids (the Kronecker NLL) and
masked ones (the matrix-free NLL, the JAX package's probes injected) in
float64 at 1e-10 -- logp and dlogp (one program each), the statistics and
the (M, M) covariance (one fused program) -- the joint draws against that
posterior, and the ``grid_*`` / ``masked_grid_*`` golden pins at
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
GT, GX = np.linspace(0, 6, 8), np.linspace(-2, 2, 6)
Q5 = np.stack([np.linspace(0.5, 5.5, 5), np.linspace(-1.5, 1.5, 5)], 1)


def _rows(dtype):
    gt, gx = GT.astype(dtype), GX.astype(dtype)
    rows = np.stack([m.ravel() for m in np.meshgrid(gt, gx, indexing="ij")], 1)
    return gt, gx, rows


def _keep():
    return np.sort(np.random.default_rng(5).choice(48, int(0.7 * 48), replace=False))


def _pair(masked, dtype=np.float64, probes=None):
    gt, gx, rows = _rows(dtype)
    rng = np.random.default_rng(99)
    y = (np.sin(rows[:, 0]) * np.exp(-0.3 * rows[:, 1] ** 2)
         + 0.1 * rng.standard_normal(rows.shape[0])).astype(dtype)
    if masked:
        rows, y = rows[_keep()], y[_keep()]
    out = []
    for lib in (g3, g3t):
        seed = 0 if lib is g3 or probes is None else probes
        proc = lib.GridGP(axes=[gt, gx], kernel=[lib.MAT32(gt[:, None]), lib.SE(gx[:, None])],
                          masked_probes=8, masked_lanczos=20, masked_seed=seed,
                          name="GR%d" % masked)
        proc.observed(rows, y)
        out.append(proc)
    return out


#: the statistics held to the JAX package's, posterior and prior
STATS = {f"{key}{prior}": (th, dict(kw, prior=prior)) for prior in (False, True)
         for key, th, kw in (("mean", "th_mean", {}), ("var", "th_variance", {}),
                             ("varn", "th_variance", {"noise": True}),
                             ("lp", "th_logpredictive", {}), ("cov", "th_covariance", {}))}


@pytest.mark.parametrize("masked", [False, True])
def test_grid_gp_matches_jax(masked):
    with floatx(F64):
        n_obs = len(_keep()) if masked else 48
        jp, tp = _pair(masked, probes=_probes(0, 8, n_obs))
        assert [q.name for q in tp.active.ordered_params] == \
            [q.name for q in jp.active.ordered_params]
        assert_close(dict(tp.params_default),
                     {k: np.asarray(v) for k, v in jp.params_default.items()}, F64)
        p = {k: np.asarray(v) * 1.1 for k, v in jp.params_default.items()}
        y_q = np.cos(Q5[:, 0])
        value, grad, want = jax_logp_dlogp(jp, p, Q5, STATS, vector=y_q)
        assert_close(tp.logp(p), value, F64)
        assert_close(tp.dlogp(p), grad, F64)
        assert_close({k: getattr(tp, th[3:])(p, Q5, vector=y_q, **kw)
                      for k, (th, kw) in STATS.items()}, want, F64)
        from scipy import stats
        m, v = to_numpy(tp.mean(p, Q5)), to_numpy(tp.variance(p, Q5, noise=True))
        assert_close(tp.quantiler(p, Q5, q=0.9, noise=True),
                     stats.norm.ppf(0.9, loc=m, scale=np.sqrt(v)), F64)


@pytest.mark.parametrize("masked", [False, True])
def test_joint_draws_have_the_posterior(masked):
    """A draw is Q_u sqrt(lam_u) eps over the augmented axes'
    eigenvectors, whose signs and order are LAPACK's (the JAX package's
    differ), so the same normals give other draws: 4000 joint draws are
    held to the (JAX-checked) posterior mean and covariance within their
    Monte-Carlo error; the prior draws to the prior covariance."""
    with floatx(F64):
        n_obs = len(_keep()) if masked else 48
        tp = _pair(masked, probes=_probes(0, 8, n_obs))[1]
        p = {k: np.asarray(v) * 1.1 for k, v in tp.params_default.items()}
        for prior in (False, True):
            draws = tp.sampler(p, Q5, samples=4000, seed=11, prior=prior)
            mean = to_numpy(tp.mean(p, Q5, prior=prior))
            cov = to_numpy(tp.covariance(p, Q5, prior=prior))
            sd = np.sqrt(np.diagonal(cov))
            assert np.all(np.abs(draws.mean(1) - mean) <= 5 * sd / np.sqrt(4000) + 1e-12)
            np.testing.assert_allclose(np.cov(draws), cov, atol=0.1 * np.max(np.diagonal(cov)))
        noisy = tp.sampler(p, Q5, samples=4000, seed=12, noise=True,
                           rng=np.random.default_rng(9))
        np.testing.assert_allclose(noisy.var(1), to_numpy(tp.variance(p, Q5, noise=True)),
                                   rtol=0.15)


GRID_PINS = ("grid_logp", "grid_dlogp_norm", "grid_mean_sum", "masked_grid_logp",
             "masked_grid_dlogp_norm")


@pytest.fixture(scope="module")
def grid_pins():
    """The pins' quantities on the port, float32, on
    tests/test_golden_families.py's workloads (its rng(99) stream after the
    NG workload's draw; the masked grid's probes the JAX package's)."""
    rng = np.random.default_rng(99)
    t4 = np.sort(np.random.default_rng(8).uniform(0, 10.0, 40)).astype(np.float32)
    rng.poisson(np.exp(0.8 * np.sin(t4)))     # the NG workload's draw
    gt = np.linspace(0, 6, 8).astype(np.float32)
    gx = np.linspace(-2, 2, 6).astype(np.float32)
    rows = g3t.grid_rows([gt, gx])
    yg = (np.sin(rows[:, 0]) * np.exp(-0.3 * rows[:, 1] ** 2)
          + 0.1 * rng.standard_normal(rows.shape[0])).astype(np.float32)
    q5 = Q5.astype(np.float32)
    gg = g3t.GridGP(axes=[gt, gx], kernel=[g3t.MAT32(gt[:, None]), g3t.SE(gx[:, None])],
                    name="GOLD_GR")
    gg.observed(rows, yg)
    keep = _keep()
    mg = g3t.GridGP(axes=[gt, gx], kernel=[g3t.MAT32(gt[:, None]), g3t.SE(gx[:, None])],
                    masked_probes=8, masked_lanczos=20, masked_seed=_probes(0, 8, len(keep)),
                    name="GOLD_MG")
    mg.observed(rows[keep], yg[keep])
    return {"grid_logp": gg.logp(), "grid_dlogp_norm": float(np.linalg.norm(gg.dlogp())),
            "grid_mean_sum": float(np.sum(to_numpy(gg.mean(space=q5)))),
            "masked_grid_logp": mg.logp(),
            "masked_grid_dlogp_norm": float(np.linalg.norm(mg.dlogp()))}


@pytest.mark.parametrize("pin", GRID_PINS)
def test_grid_pins_hold_on_port(grid_pins, pin):
    with open(GOLDEN) as fh:
        gold = json.load(fh)
    np.testing.assert_allclose(grid_pins[pin], gold[pin], rtol=5e-5, atol=5e-5)


def test_kernel_calls_rows_and_errors(monkeypatch):
    """One K1 gram an axis an evaluation; grid_rows is the JAX package's;
    the guards and errors."""
    np.testing.assert_array_equal(g3t.grid_rows([GT, GX]), g3.grid_rows([GT, GX]))
    gt, gx, rows = _rows(np.float32)
    y = np.sin(rows[:, 0]).astype(np.float32)
    tp = g3t.GridGP(axes=[gt, gx], kernel=[g3t.MAT32(gt[:, None]), g3t.SE(gx[:, None])],
                    name="GK")
    tp.observed(rows, y)
    spy = KernelSpy(monkeypatch)
    tp.logp()
    tp.dlogp()
    assert spy.take() == (4, 0)
    with pytest.raises(NotImplementedError, match="item 16"):
        tp.nll_distributed(tp.params)
    with pytest.raises(ValueError, match="one separable factor"):
        g3t.GridGP(axes=[gt], kernel=g3t.SE(gt[:, None]), name="GE1")
    with pytest.raises(ValueError, match="duplicate"):
        g3t.GridGP(axes=[gt, gx], kernel=[g3t.SE(gt[:, None]), g3t.SE(gx[:, None])],
                   name="GE2").observed(np.concatenate([rows[:3], rows[:1]]), y[:4])
