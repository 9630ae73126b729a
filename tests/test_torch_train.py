"""Port parity of the training slice: the registry's flat-vector map,
``logp(array=True)``, ``dlogp`` (GP and WGP on the golden workload, f32 and
f64, and the ``gp_dlogp_norm`` pin), ``find_MAP`` against the JAX
package's, the hardened ``optimize`` and the default device."""

import json
import os

import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.bayesian.selection import optimize

from torch_parity import assert_close, floatx

GOLDEN = os.path.join(os.path.dirname(__file__), "golden.json")


def _pair(kind, name):
    """The golden workload (tests/test_golden.py) in both packages."""
    rng = np.random.default_rng(1234)
    x = np.linspace(0, 10, 32).astype(np.float32).reshape(-1, 1)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(32)).astype(np.float32)
    if kind == "gp":
        jp = g3.GP(space=x, location=g3.Bias(), kernel=g3.SE(x), name=name)
        tp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name=name)
    else:
        y = (np.exp(0.3 * y) + 1.0).astype(np.float32)
        jp = g3.WGP(space=x, location=g3.Bias(), kernel=g3.SE(x),
                    mapping=g3.BoxCoxLinear(y), name=name)
        tp = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x),
                     mapping=g3t.BoxCoxLinear(y), name=name)
    jp.observed(x, y)
    tp.observed(x, y)
    return jp, tp


def test_default_device_is_the_card():
    assert g3t.config.Settings().device == "cuda"


def test_gp_dlogp_norm_pin():
    with open(GOLDEN) as f:
        want = json.load(f)["gp_dlogp_norm"]
    _, tp = _pair("gp", "PIN_DGP")
    g = tp.dlogp()
    assert isinstance(g, np.ndarray) and g.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(g), want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_dlogp_and_array_logp_match_jax(kind, name):
    with floatx(name):
        jp, tp = _pair(kind, f"D_{kind.upper()}_{name[-2:]}")
        rng = np.random.default_rng(3)
        u0 = jp.active.dict_to_array(jp.params_default)
        for u in (u0, u0 + 0.3 * rng.standard_normal(u0.shape).astype(name)):
            assert_close(tp.dlogp(u), np.asarray(jp.dlogp(u)), name=name,
                         err_msg=f"{kind} dlogp")
            assert_close(tp.logp(u, array=True), jp.logp(u, array=True), name=name)
            assert_close(tp.loglike(u, array=True), jp.loglike(u, array=True), name=name)
        # dict and array forms of one point agree
        assert_close(tp.logp(tp.active.array_to_dict(u0)), tp.logp(u0, array=True),
                     name=name)


def test_registry_flat_vector_parity():
    jp, tp = _pair("wgp", "REG_WGP")
    jr, tr = jp.active, tp.active
    params = {k: np.asarray(v) for k, v in jp.params_random(
        sigma=0.2, rng=np.random.default_rng(4)).items()}
    u = jr.dict_to_array(params)
    assert_close(tr.dict_to_array(params), u)
    assert_close(tr.array_to_dict_tensor(torch.as_tensor(u)), dict(jr.array_to_dict_jax(u)))
    assert_close(tr.sampling_params(params), jr.sampling_params(params))
    assert tr.sampling_dims == jr.sampling_dims
    assert_close(dict(tr.dict_from_sampling_array(u)), dict(jr.dict_from_sampling_array(u)))
    # a differentiable map: d exp(u)/du = exp(u) for the log-transformed hypers
    ut = torch.as_tensor(u).requires_grad_(True)
    total = sum(v.sum() for v in tr.array_to_dict_tensor(ut).values())
    (g,) = torch.autograd.grad(total, ut)
    names = tr.param_names()
    for i, nm in enumerate(names):
        want = 1.0 if nm.endswith("Bias") or nm.endswith("shift") else float(np.exp(u[i]))
        np.testing.assert_allclose(float(g[i]), want, rtol=1e-6)


def test_set_params_makes_current_params():
    _, tp = _pair("gp", "SET_GP")
    p = dict(tp.params_default)
    p["SET_GP_Noise_var"] = np.asarray(0.05, np.float32)
    tp.set_params(p)
    assert float(tp.params["SET_GP_Noise_var"]) == pytest.approx(0.05)
    assert tp.logp() == pytest.approx(tp.logp(p))
    tp.set_params(None)
    assert float(tp.params["SET_GP_Noise_var"]) != pytest.approx(0.05)


@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_find_map_matches_jax(kind):
    with floatx("float64"):
        jp, tp = _pair(kind, f"MAP_{kind.upper()}")
        start = tp.logp()
        got = tp.find_MAP(points=2, display=False)
        want = jp.find_MAP(points=2, display=False)
        got_logp, want_logp = tp.logp(got), jp.logp(want)
    assert got_logp > start + 1.0
    np.testing.assert_allclose(got_logp, want_logp, rtol=1e-4)


def test_find_map_return_points_and_unported_options():
    _, tp = _pair("gp", "OPT_GP")
    params, points = tp.find_MAP(points=1, powell=False, display=False,
                                 return_points=True)
    assert [p[0] for p in points] == ["start", "start_bfgs"]
    assert points[1][1] >= points[0][1]
    assert set(params) == set(tp.params_default)
    # the band-sharded engine on a mesh of one (no process group;
    # tests/test_torch_distributed_models.py runs it on 2 and 4 ranks)
    dist = tp.find_MAP(display=False, engine="distributed", max_iters=30)
    assert set(dist) == set(tp.params_default)
    assert tp.logp(dist) > tp.logp(tp.params_default)
    # plot=True draws the start and each visited point (the Agg backend)
    plt = g3t.utils.plots.pyplot()
    plt.close("all")
    tp.find_MAP(points=1, powell=False, display=False, plot=True)
    assert len(plt.get_fignums()) == 2
    plt.close("all")
    # engine='iterative' is ported (tests/test_torch_iterative_gp.py): an
    # unknown loop reaches its own check
    for kw in (dict(engine="nope"), dict(objective="nope"),
               dict(engine="iterative", loop="nope")):
        with pytest.raises(ValueError):
            tp.find_MAP(display=False, **kw)


def test_optimize_hardening():
    def logp(p):  # a concave bowl with a NaN hole and a raising region
        if p[0] > 5:
            raise RuntimeError("outside the model's domain")
        if p[0] < -5:
            return np.nan
        return -float(np.sum((p - 1.0) ** 2))

    def dlogp(p):
        return -2.0 * (p - 1.0)

    out = optimize(logp, np.zeros(2, np.float32), dlogp=dlogp, fmin="bfgs")
    np.testing.assert_allclose(out, [1.0, 1.0], atol=1e-4)
    out = optimize(logp, np.zeros(2, np.float32), fmin="powell")
    np.testing.assert_allclose(out, [1.0, 1.0], atol=1e-3)

    def bad_grad(p):
        raise RuntimeError("no gradient here")

    out = optimize(logp, np.zeros(2, np.float32), dlogp=bad_grad, fmin="bfgs")
    assert np.all(np.isfinite(out))
    start = np.full(2, 0.5, np.float32)
    np.testing.assert_array_equal(optimize(logp, start, dlogp=dlogp, max_time=-1.0), start)
