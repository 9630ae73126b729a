"""Port parity of the batched L-BFGS behind ``find_MAP(engine='jax')``
(g3py_tpu_torch/bayesian/optimize_jax.py): the optimum of every start
against the JAX package's ``optax`` L-BFGS to 1e-6 in float64 on a
quadratic, on Rosenbrock and through ``find_MAP(engine='jax')`` on a
GP(Bias, SE) with n=24, by its marginal likelihood and by its leave-one-out
objective (one batched evaluation of the searching starts at a time); in
float32 the JAX tests' own tolerances against the scipy engine
(tests/test_analytics.py ``TestFindMapJax``, tests/test_gp.py's LOO case);
non-finite objectives and the return points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
from g3py_tpu.bayesian import optimize_jax as jopt
from g3py_tpu_torch.bayesian import optimize_jax as topt

from torch_parity import KernelSpy, floatx, process_pair

A = np.array([[3.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 1.0]])
B = np.array([1.0, -2.0, 0.5])


def _quad(lib):
    a, b = (jnp.asarray(A), jnp.asarray(B)) if lib == "jax" else (torch.as_tensor(A),
                                                                 torch.as_tensor(B))
    if lib == "jax":
        return lambda p: -0.5 * p @ a @ p + b @ p
    return lambda p: -0.5 * ((p @ a) * p).sum(-1) + p @ b


def _rosen(lib):
    if lib == "jax":
        return lambda p: -((1 - p[0]) ** 2 + 100 * (p[1] - p[0] ** 2) ** 2)
    return lambda p: -((1 - p[:, 0]) ** 2 + 100 * (p[:, 1] - p[:, 0] ** 2) ** 2)


@pytest.mark.parametrize("name, starts", [
    ("quad", [[0.0, 0.0, 0.0], [5.0, -3.0, 2.0], [-1.0, 4.0, 0.5]]),
    ("rosen", [[-1.2, 1.0], [0.0, 0.0], [2.0, 2.5]])])
def test_toy_optimum_matches_jax(name, starts):
    build = {"quad": _quad, "rosen": _rosen}[name]
    with floatx("float64"):
        want_x, want_v = jopt.lbfgs_maximize(build("jax"), np.asarray(starts), max_iters=200)
        got_x, got_v = topt.lbfgs_maximize(build("torch"), np.asarray(starts), max_iters=200)
    assert got_x.shape == want_x.shape and got_v.shape == (len(starts),)
    np.testing.assert_allclose(got_x, np.asarray(want_x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=1e-6, atol=1e-6)
    # one batched evaluation of the searching starts at a time
    assert topt.lbfgs_maximize.evaluations < 30 * topt.lbfgs_maximize.iterations


def _gp_pair(name, n=24, seed=1):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 8, n).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    return process_pair(lambda lib: lib.GP(space=x, location=lib.Zero(), kernel=lib.SE(x),
                                           name=name), x, y)


@pytest.mark.parametrize("objective", ["logp", "loo"])
def test_find_map_jax_matches_jax(monkeypatch, objective):
    with floatx("float64"):
        jp, tp = _gp_pair("LBFGS_" + objective.upper())
        kw = dict(points=3, engine="jax", display=False, objective=objective, max_iters=300,
                  return_points=True)
        want, want_pts = jp.find_MAP(**kw)
        spy = KernelSpy(monkeypatch)
        got, got_pts = tp.find_MAP(**kw)
        k1, k2 = spy.take()
        assert k1 == k2 == topt.lbfgs_maximize.evaluations  # every evaluation batched
        score = (lambda p, m: m.loo(p)) if objective == "loo" else (lambda p, m: m.logp(p))
        np.testing.assert_allclose(float(score(got, tp)), float(score(want, jp)), rtol=1e-6)
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert [p[0] for p in got_pts] == [p[0] for p in want_pts]
        np.testing.assert_allclose([p[1] for p in got_pts], [p[1] for p in want_pts],
                                   rtol=1e-6)


def test_find_map_jax_float32_against_scipy():
    """The JAX tests' float32 tolerances: the jax engine's logp within
    rtol 1e-2, atol 0.5 of the scipy engine's, and its LOO at least the
    scipy LOO optimum less 0.5."""
    _, tp = _gp_pair("LBFGS_F32")
    p_jax = tp.find_MAP(points=2, engine="jax", display=False)
    p_sci = tp.find_MAP(points=2, display=False)
    np.testing.assert_allclose(tp.logp(p_jax), tp.logp(p_sci), rtol=1e-2, atol=0.5)
    pm_sc = tp.find_MAP(points=1, powell=False, display=False, objective="loo")
    pm_jx = tp.find_MAP(engine="jax", points=2, display=False, objective="loo", max_iters=300)
    loo_jx = float(tp.loo(pm_jx))
    assert np.isfinite(loo_jx) and loo_jx >= float(tp.loo(pm_sc)) - 0.5


def test_guards_and_refusals():
    def logp(p):  # a bowl with a non-finite region beyond p0 > 2
        v = -((p - 1.0) ** 2).sum(-1)
        return torch.where(p[:, 0] > 2.0, torch.full_like(v, float("nan")), v)

    with floatx("float64"):
        x, v = topt.lbfgs_maximize(logp, np.array([[1.9, -3.0], [-4.0, 0.5]]))
    np.testing.assert_allclose(x, 1.0, atol=1e-5)
    np.testing.assert_allclose(v, 0.0, atol=1e-9)
    _, tp = _gp_pair("LBFGS_FIX", n=12)
    u0 = tp.active.dict_to_array(tp.params_default)
    cols = {c: np.tile(u0[i], 2) for i, c in enumerate(tp.active.param_names())}
    tp.active.fix_vars(g3t.Datatrace(cols), [tp.active.param_names()[0]])
    try:
        with pytest.raises(ValueError, match="fix_vars"):
            tp.find_MAP(engine="jax", objective="loo", display=False)
    finally:
        tp.active.fix_vars()
