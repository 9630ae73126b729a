"""Port parity of the band-sharded model consumers on gloo worlds of D = 1,
2 and 4 CPU ranks (``tests/torch_dist.py``), n = 64, d = 2:

* GP, WGP, TP and WTP ``nll_distributed``, value and gradient in the flat
  vector, against the JAX package's ``-loglike`` and its gradient (x64 at
  1e-10, float32 at rtol 1e-4 / atol 1e-5: the band objective is the dense
  one to rounding, and the JAX package's band code does not run under x64,
  ROADMAP Queue 3), against the JAX package's band ``nll_distributed`` of
  the GP (float32, a 2-device mesh) and against the port's own -loglike;
* ``find_MAP(engine='distributed')`` against the JAX package's MAP (the
  JAX test's criterion: within 1 nat of its optimum);
* ``predictor_distributed``'s statistics against the JAX package's x64
  Predictor and the port's own, and
  its pathwise sampler fed the JAX package's draws against the JAX
  package's Predictor paths from the same key;
* ``Experiment(engine='distributed')`` against the scipy engine's (the
  JAX package's Experiment and the port's), and the three refusals."""

import concurrent.futures

import jax
import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.parallel import make_mesh

from test_torch_pathwise import F, S, _injected
from torch_dist import world
from torch_dist_work import build
from torch_parity import F32_TOL, floatx, nudged

N, DS, KINDS = 64, (1, 2, 4), ("gp", "wgp", "tp", "wtp")


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, 2))
    y = np.exp(0.3 * np.sin(2.0 * x[:, 0]) + 0.05 * rng.standard_normal(n))
    return x, y


def _params(kind):
    """Off-default params of each family, from the JAX package's defaults."""
    x, y = _data()
    with floatx("float64"):
        return {k: np.asarray(v, np.float64) for k, v in
                nudged(build(g3, kind, x, y, f"DM_{kind.upper()}").params_default).items()}


XQ = np.random.default_rng(3).uniform(-2.0, 2.0, (7, 2))


def _tasks(d):
    x, y = _data()
    tasks = [(f"nll_{kind}_{fx}", "nll",
              dict(kind=kind, x=x, y=y, name=f"DM_{kind.upper()}", params=_params(kind),
                   floatx=fx)) for kind in KINDS for fx in ("float64", "float32")]
    tasks += [("map", "find_map", dict(kind="gp", x=x, y=y, name="DM_MAP", max_iters=30)),
              ("map_display", "find_map", dict(kind="gp", x=x, y=y, name="DM_MAPD",
                                               max_iters=30, display=True)),
              ("experiment", "experiment", dict(x=x, y=y, name="DM_EXP"))]
    with floatx("float64"):
        draws = _injected(None, None, [(None, None, 2)], 3, N, len(XQ), True)
    tasks += [(f"pred_{kind}", "predictor",
               dict(kind=kind, x=x, y=y, name=f"DM_{kind.upper()}", params=_params(kind),
                    xq=XQ, draws=draws, samples=S, n_features=F)) for kind in ("gp", "wgp")]
    if d == 4:
        x66, y66 = _data(66)
        tasks.append(("refuse", "refusals", dict(x=x66, y=y66, name="DM_REF")))
    return tasks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("distributed_models")
    with concurrent.futures.ThreadPoolExecutor(len(DS)) as pool:
        runs = {d: pool.submit(world, d, _tasks(d), base) for d in DS}
        return {d: r.result() for d, r in runs.items()}


def _jax_nll(kind, name):
    """``(-loglike, its gradient in the flat vector)`` of the JAX package's
    process, jitted, in the active precision."""
    x, y = _data()
    jp = build(g3, kind, x, y, name)
    reg, like = jp.active, jp._loglike_pure()
    data = (*jp._resolve_data(None, None, None), np.zeros(0))
    u = np.asarray(reg.dict_to_array(_params(kind)), dtype=g3.settings.floatx)
    v, g = jax.jit(jax.value_and_grad(lambda w: -like(reg.array_to_dict_jax(w), *data)))(u)
    return float(v), np.asarray(g)


@pytest.fixture(scope="module")
def reference():
    out = {}
    for fx in ("float64", "float32"):
        with floatx(fx):
            for kind in KINDS:
                out[kind, fx] = _jax_nll(kind, f"DM_{kind.upper()}")
    return out


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("kind", KINDS)
def test_nll_distributed_matches_jax_and_loglike(worlds, reference, kind, d):
    """float32 gradients are held at rtol 1e-4 and an atol of 1e-5 of the
    gradient's largest entry: the Student-t nu entry (~4e-3) is a
    difference of terms of the gradient's size, and the port's dense
    float32 gradient is itself 1.9e-5 off the JAX package's there."""
    for fx in ("float64", "float32"):
        want_v, want_g = reference[kind, fx]
        tol = dict(rtol=1e-10, atol=1e-10) if fx == "float64" else F32_TOL
        gtol = tol if fx == "float64" else dict(
            rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(want_g).max())))
        for r in worlds[d]:
            got = r[f"nll_{kind}_{fx}"]
            np.testing.assert_allclose(got["nll"], want_v, **tol, err_msg=f"{kind} {fx}")
            np.testing.assert_allclose(got["grad"], want_g, **gtol, err_msg=f"{kind} {fx}")
            np.testing.assert_allclose(got["nll"], -got["loglike"], **tol)
            np.testing.assert_allclose(got["grad"], -got["loglike_grad"], **gtol)
            # all-reduced: the same bits on every rank
            np.testing.assert_array_equal(got["grad"], worlds[d][0][f"nll_{kind}_{fx}"]["grad"])


def test_nll_distributed_matches_jax_band_float32(worlds):
    """The JAX package's own band NLL of the GP on a 2-device mesh (value
    and gradient through its custom VJP)."""
    x, y = _data()
    with floatx("float32"):
        jp = build(g3, "gp", x.astype(np.float32), y.astype(np.float32), "DM_GP")
        reg, mesh = jp.active, make_mesh(n_devices=2)
        u = np.asarray(reg.dict_to_array(_params("gp")), np.float32)
        v, g = jax.jit(jax.value_and_grad(
            lambda w: jp.nll_distributed(reg.array_to_dict_jax(w), mesh=mesh)))(u)
    for d in DS:
        got = worlds[d][0]["nll_gp_float32"]
        np.testing.assert_allclose(got["nll"], float(v), **F32_TOL)
        np.testing.assert_allclose(got["grad"], np.asarray(g), **F32_TOL)


def test_find_map_distributed_reaches_the_jax_optimum(worlds):
    x, y = _data()
    with floatx("float64"):
        jp = build(g3, "gp", x, y, "DJ_MAP")
        lp_ref = float(jp.logp(jp.find_MAP(points=1, powell=False, display=False)))
        tp = build(g3t, "gp", x, y, "DT_MAP")
        lp0 = tp.logp()
    for d in DS:
        for r in worlds[d]:
            got = r["map"]
            assert got["logp"] >= lp_ref - 1.0, (d, got["logp"], lp_ref)
            assert got["logp"] > lp0 + 1.0
            assert got["logp"] == worlds[d][0]["map"]["logp"]  # the ranks in lockstep


@pytest.mark.parametrize("d", DS)
def test_find_map_distributed_display_keeps_the_ranks_in_step(worlds, d):
    """``display=True`` (the default) evaluates the start on every rank and
    prints on rank 0 only: the same optimum as ``display=False``."""
    for r in worlds[d]:
        got = r["map_display"]
        assert got["logp"] == worlds[d][0]["map"]["logp"]
        assert ("start1 (-logp)" in got["printed"]) == (r is worlds[d][0]), got["printed"]


PRED_KW = dict(var=True, median=True, quantiles=True, quantiles_noise=True)


@pytest.fixture(scope="module")
def jax_predictions():
    """The JAX package's x64 Predictor statistics at ``XQ``, host arrays."""
    x, y = _data()
    out = {}
    with floatx("float64"):
        for kind in ("gp", "wgp"):
            jp = build(g3, kind, x, y, f"DM_{kind.upper()}")
            out[kind] = {k: np.asarray(v) for k, v in
                         jp.predictor(_params(kind))(XQ, **PRED_KW).items()}
    return out


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_predictor_distributed_matches_the_predictor(worlds, jax_predictions, kind, d):
    """The band predictor's statistics against the JAX package's x64
    Predictor and the port's own Predictor on the same inputs."""
    x, y = _data()
    with floatx("float64"):
        tp = build(g3t, kind, x, y, f"DM_{kind.upper()}")
        port = tp.predictor(_params(kind))(XQ, **PRED_KW)
    jax_want = jax_predictions[kind]
    assert set(jax_want) == set(port)
    for r in worlds[d]:
        got = r[f"pred_{kind}"]
        assert got["l_band"] == (N // d, N)
        assert set(got["stats"]) == set(port)
        for label, want in (("jax", jax_want), ("port", port)):
            for k in want:
                np.testing.assert_allclose(got["stats"][k], want[k], rtol=1e-9, atol=1e-10,
                                           err_msg=f"{kind} {k} against the {label} Predictor")


@pytest.mark.parametrize("d", DS)
def test_distributed_sampler_matches_jax_paths(worlds, d):
    """The band sampler fed the JAX package's draws (key 3) against the JAX
    package's Predictor paths from that key (the same Matheron update,
    exact in both)."""
    x, y = _data()
    with floatx("float64"):
        jp = build(g3, "gp", x, y, "DM_GP")
        want = jp.predictor(_params("gp")).pathwise_sampler(space=XQ, samples=S, key=3,
                                                             n_features=F, noise=True)
    for r in worlds[d]:
        np.testing.assert_allclose(r["pred_gp"]["draws"], np.asarray(want), rtol=1e-9,
                                   atol=1e-10)


def test_experiment_distributed_matches_scipy(worlds):
    """The distributed engine's held-out error against the scipy engine's,
    of the JAX package's Experiment and of the port's, on the same split."""
    x, y = _data()
    want = {}
    with floatx("float64"):
        for lib in (g3, g3t):
            e = lib.Experiment()
            e.add_model(build(lib, "gp", x, y, "DM_EXP"))
            e.set_data(x, y, p=0.75)
            e.run(n_simulations=1)
            want[lib.__name__] = float(e.results["test_l2"][0])
    for d in DS:
        for r in worlds[d]:
            got = r["experiment"]
            assert np.isfinite(got["test_l2"]).all()
            for label, value in want.items():
                np.testing.assert_allclose(got["test_l2"][0], value, rtol=1e-3, err_msg=label)
            np.testing.assert_array_equal(got["test_l2"], worlds[d][0]["experiment"]["test_l2"])


def test_the_three_refusals(worlds):
    for r in worlds[4]:
        assert "divide evenly over the 4-device mesh" in r["refuse"]
    x, y = _data()
    quiet = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), noisy=False, name="DR_Q")
    quiet.observed(x, y)
    with pytest.raises(ValueError, match="noisy=True"):
        quiet.nll_distributed()
    inner = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x) + g3t.KernelNoise(x),
                   name="DR_K")
    inner.observed(x, y)
    for call in (inner.nll_distributed, inner.predictor_distributed):
        with pytest.raises(ValueError, match="KernelNoise"):
            call()
    with pytest.raises(ValueError, match="KernelNoise"):
        inner.find_MAP(engine="distributed", display=False)
