"""``Predictor.export`` and the model-free loader (``g3py_tpu_torch.
serving.load_predictor``): the round trip with a symbolic and a fixed
query batch, the manifest and the files (the JAX package's keys), the
refusals (no statistic, a stale predictor, a warped covariance, quantiles
without ``_quantile_p``), the loaded GP, WGP(BoxCoxLinear) and
WGP(WarpingTanh) statistics against the live predictor and the JAX
package's, an SGP's sparse state likewise, K1 recorded as the registered
operator, the loader in a fresh
process importing no model code, and the traced Newton (the
``while_loop`` form an exported warping runs) against the host loop."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
from g3py_tpu_torch.ops.root import _solve, newton_inverse
from g3py_tpu_torch.serving import load_predictor

from torch_parity import assert_close, floatx, nudged, process_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = dict(mean=True, std=True, quantiles=True, quantiles_noise=True)
JAX_STATE_KEYS = {"format", "process", "statistics", "platforms", "symbolic_batch", "batch",
                  "n_obs", "ndim", "dtype"}


def _data(n=30, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y, rng.standard_normal((20, 2))


MODELS = {
    "gp": lambda lib, x, y: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x), name="XG"),
    "boxcox": lambda lib, x, y: lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                        mapping=lib.BoxCoxLinear(y), name="XB"),
    "tanh": lambda lib, x, y: lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                      mapping=lib.WarpingTanh(y, n=2), name="XT"),
    # the sparse (SGPR) state: (Luu, LB~, cw, ...) m-sized, one (m, s) cross gram a batch
    "sgp": lambda lib, x, y: lib.SGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                     inducing=x[::5] + 0.01, name="XS"),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_loaded_statistics_match_live_and_jax(model, tmp_path):
    x, y, xq = _data()
    if model in ("boxcox", "tanh"):
        y = np.exp(0.3 * y) + 1.0
    flags = FLAGS if model != "tanh" else dict(mean=True, std=True, quantiles=True)
    with floatx("float32"):
        jp, tp = process_pair(lambda lib: MODELS[model](lib, x, y), x, y)
        params = nudged(jp.params_default)
        pr = tp.predictor(g3t.params_from_jax(tp, params))
        path = pr.export(str(tmp_path / model), **flags)
        ep = load_predictor(path)
        assert ep.statistics == list(pr(xq[:2], **flags))
        want = jp.predictor(params)(xq, **flags)
        for m in (1, 7, 20):
            got = ep(xq[:m])
            live = pr(xq[:m], **flags)
            for k in live:
                np.testing.assert_allclose(got[k].numpy(), live[k], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{model} {k} m={m}")
            assert_close({k: got[k] for k in want}, {k: want[k][:m] for k in want}, "float32")
        torch.testing.assert_close(ep.mean(xq[:3]), got["mean"][:3])
        program = torch.export.load(os.path.join(path, "bundle.pt2"))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        # one cross gram a query batch (the query gram's diagonal is var)
        assert targets.count("g3py_tpu_torch.stationary_gram.default") == 1, model


def test_fixed_batch_manifest_files_and_refusals(tmp_path, monkeypatch):
    x, y, xq = _data(n=16)
    with floatx("float32"):
        gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="XF")
        gp.observed(x, y)
        pr = gp.predictor()
        path = pr.export(str(tmp_path / "fixed"), batch=5, var=True, median=True)
        assert sorted(os.listdir(path)) == ["bundle.pt2", "manifest.json", "state.npz"]
        with open(os.path.join(path, "manifest.json")) as fh:
            man = json.load(fh)
        assert JAX_STATE_KEYS <= set(man) and man["device"] == "cpu"
        assert (man["batch"], man["symbolic_batch"], man["n_obs"], man["ndim"]) == (5, False,
                                                                                   16, 2)
        assert man["statistics"] == ["mean", "variance", "std", "median"]
        assert man["platforms"] == ["cpu", "cuda"] and man["dtype"] == "float32"
        state = np.load(os.path.join(path, "state.npz"))
        assert {"inputs", "outputs"} <= set(state.files)
        assert {"merged/_state_obs_linv", "merged/XF_SE_var"} <= set(state.files)
        ep = load_predictor(path)
        assert ep(xq[:5])["variance"].shape == (5,)
        with pytest.raises(Exception):
            ep(xq[:6])
        with pytest.raises(ValueError, match="exported for"):
            load_predictor(pr.export(str(tmp_path / "cpuonly"), platforms=("cpu",)),
                           device="cuda")
        with pytest.raises(ValueError, match="at least one"):
            pr.export(str(tmp_path / "none"), mean=False, std=False)
        wgp = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x),
                      mapping=g3t.BoxCoxLinear(np.exp(y)), name="XW")
        wgp.observed(x, np.exp(y))
        with pytest.raises(ValueError, match="covariance"):
            wgp.predictor().export(str(tmp_path / "cov"), cov=True)
        monkeypatch.delattr(g3t.GaussianProcess, "_quantile_p")
        with pytest.raises(ValueError, match="_quantile_p"):
            pr.export(str(tmp_path / "q"), quantiles=True)
        monkeypatch.undo()
        gp.observed(x[:8], y[:8])
        with pytest.raises(ValueError, match="rebuild"):
            pr.export(str(tmp_path / "stale"))


def test_loader_imports_no_model_code(tmp_path):
    """A fresh process loads and serves the artifact with
    ``g3py_tpu_torch.serving`` alone: no models, hypers or bayesian module,
    no JAX."""
    x, y, xq = _data(n=12)
    with floatx("float32"):
        gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="XS")
        gp.observed(x, y)
        pr = gp.predictor()
        path = pr.export(str(tmp_path / "sub"), quantiles=True)
        live = pr(xq, quantiles=True)
    np.save(tmp_path / "xq.npy", xq.astype(np.float32))
    code = (
        "import sys, numpy as np\n"
        "import g3py_tpu_torch.serving as s\n"
        "s.settings.device = 'cpu'\n"
        f"ep = s.load_predictor({str(path)!r})\n"
        f"out = ep(np.load({str(tmp_path / 'xq.npy')!r}))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'g3py_tpu') or m in\n"
        "       ('g3py_tpu_torch.models', 'g3py_tpu_torch.hypers', 'g3py_tpu_torch.bayesian')]\n"
        "assert not bad, bad\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, **{{k: v.numpy() for k, v in out.items()}})\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(tmp_path),
                   timeout=300)
    out = np.load(tmp_path / "out.npz")
    for k in live:
        np.testing.assert_allclose(out[k], live[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_traced_newton_equals_the_host_loop(name):
    """The ``while_loop`` form of the bracketed Newton (what an exported
    warping runs) gives the host loop's values: one solve, and rows that
    stop on their own."""
    with floatx(name):
        y = np.exp(np.random.default_rng(2).standard_normal(40)) + 1.0
        wt = g3t.WarpingTanh(y, n=2)
        wt.check_hypers("NT_")
        p = {k.name: torch.as_tensor(np.asarray(v)) for k, v in wt.default_hypers(None, y).items()}
        p["NT_WarpingTanh_b"] = p["NT_WarpingTanh_b"] * 8.0
        z = torch.as_tensor(np.linspace(-3, 9, 40).astype(name))
        for rows in (0, 1):
            params = p if rows == 0 else {k: torch.stack([v, 1.5 * v]) for k, v in p.items()}
            zz = z if rows == 0 else torch.stack([z, z + 1.0])
            def g(v):
                return wt.inv(params, v) - zz

            loops = [_solve(g, torch.zeros_like(zz), 1e-6, 100, 1.0, rows,
                            lambda v: wt.inv_slope(params, v), traced)
                     for traced in (False, True)]
            host, traced = loops
            torch.testing.assert_close(traced, host, rtol=0, atol=0)
            torch.testing.assert_close(newton_inverse(lambda v: wt.inv(params, v), zz,
                                                      row_dims=rows,
                                                      dfunc=lambda v: wt.inv_slope(params, v)),
                                       host, rtol=0, atol=0)
            assert float((wt.inv(params, host) - zz).abs().max()) < 1e-3
