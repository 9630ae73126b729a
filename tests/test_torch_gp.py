"""Port parity end to end: GP and WGP on the golden workload
(tests/test_golden.py), at default params and at a perturbed params dict
carried across from JAX with ``params_from_jax`` — logp, mean, std,
quantiles and noise bands, through the process and through the Predictor —
and against the golden pins."""

import json
import os

import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.utils import params_from_jax

from torch_parity import assert_close, floatx

GOLDEN = os.path.join(os.path.dirname(__file__), "golden.json")
STATS = dict(mean=True, std=True, var=True, quantiles=True, quantiles_noise=True)


def _golden_data():
    rng = np.random.default_rng(1234)
    x = np.linspace(0, 10, 32).astype(np.float32).reshape(-1, 1)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(32)).astype(np.float32)
    y_pos = (np.exp(0.3 * y) + 1.0).astype(np.float32)
    return x, y, y_pos


def _pair(kind, name):
    x, y, y_pos = _golden_data()
    if kind == "gp":
        jp = g3.GP(space=x, location=g3.Bias(), kernel=g3.SE(x), name=name)
        tp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name=name)
        obs = y
    else:
        jp = g3.WGP(space=x, location=g3.Bias(), kernel=g3.SE(x),
                    mapping=g3.BoxCoxLinear(y_pos), name=name)
        tp = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x),
                     mapping=g3t.BoxCoxLinear(y_pos), name=name)
        obs = y_pos
    jp.observed(x, obs)
    tp.observed(x, obs)
    return jp, tp, x


def _jax_stats(jp, params, xq):
    out = {k: np.asarray(v) for k, v in jp.predictor(params).predict(space=xq, **STATS).items()}
    out["logp"] = np.asarray(jp.logp(params))
    return out


def _torch_stats(tp, params, xq):
    out = dict(tp.predictor(params).predict(xq, **STATS))
    out["logp"] = np.asarray(tp.logp(params))
    return out


@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_golden_pins(kind):
    with open(GOLDEN) as f:
        want = json.load(f)
    _, tp, _ = _pair(kind, f"PIN_{kind.upper()}")
    got = {f"{kind}_logp_default": tp.logp(),
           f"{kind}_mean_sum": float(tp.mean().sum()),
           f"{kind}_std_sum": float(tp.std().sum()),
           f"{kind}_quantile_up_sum": float(tp.quantiler(q=0.975).sum())}
    for k, v in got.items():  # the golden test's own tolerance
        np.testing.assert_allclose(v, want[k], rtol=2e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_slice_default_and_perturbed_params(kind):
    jp, tp, x = _pair(kind, f"E2E_{kind.upper()}")
    xq = np.linspace(-1.0, 11.0, 24).astype(np.float32).reshape(-1, 1)
    default = jp.params_default
    perturbed = {k: np.asarray(v) for k, v in jp.params_random(
        sigma=0.2, rng=np.random.default_rng(5)).items()}
    for params in (default, perturbed):
        tparams = params_from_jax(tp, params)
        want = _jax_stats(jp, params, xq)
        assert_close(_torch_stats(tp, tparams, xq), want, err_msg=kind)
        # the process-level statistics agree with the Predictor's
        proc = tp.predict(tparams, space=xq, **STATS)
        for k, v in proc.items():
            assert_close(v, want[k], err_msg=f"{kind} process-level {k}")


def test_gp_float64_tight():
    with floatx("float64"):
        jp, tp, x = _pair("gp", "X64_GP")
        xq = np.linspace(-1.0, 11.0, 16).reshape(-1, 1)
        params = jp.params_default
        got = _torch_stats(tp, params_from_jax(tp, params), xq)
        assert got["mean"].dtype == np.float64
        assert_close(got, _jax_stats(jp, params, xq), name="float64")


def test_logp_guard_on_nonfinite_data():
    _, tp, x = _pair("gp", "GUARD_GP")
    y = np.sin(x[:, 0])
    y[3] = np.nan
    tp.observed(x, y)
    assert tp.logp() == pytest.approx(-1e30)


def test_predictor_rejects_changed_data():
    _, tp, x = _pair("gp", "STALE_GP")
    pr = tp.predictor()
    tp.observed(x, np.cos(x[:, 0]))
    with pytest.raises(ValueError, match="observed data changed"):
        pr(x)
