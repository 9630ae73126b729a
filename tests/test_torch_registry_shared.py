"""The shared active registry on the port: ``GraphicalModel.active``,
``activate``, ``get_model``, the ``Model`` alias, ``active=True`` joining
(or creating) the active registry and ``compat.modelcontext()`` without a
model, each as the JAX package does them; tutorial 08 (two GPs sharing one
ARD_L2 rate ``Param`` in one registry: the joint logp, ``dlogp`` against
``jax.grad`` and the joint float64 ``find_MAP`` against the JAX package's
optimum within 1e-6); and tutorial 03's kernel zoo run on the port.  Every
test resets the class-level registry around itself, as
tests/test_registry.py does."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from torch_parity import floatx, jax_eager, nudged


@pytest.fixture(autouse=True)
def fresh_registry():
    g3.GraphicalModel.active = None
    g3t.GraphicalModel.active = None
    yield
    g3.GraphicalModel.active = None
    g3t.GraphicalModel.active = None


def _sine(n, seed):
    """examples/_common.py's sine_data."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 10, n).astype(np.float32)
    return x.reshape(-1, 1), (np.sin(x) + 0.15 * rng.standard_normal(n)).astype(np.float32)


def test_registry_activation_matches_jax():
    for lib in (g3, g3t):
        assert lib.get_model() is lib.GraphicalModel.active  # a new one, active
        gm = lib.Model("GM_A")
        assert lib.GraphicalModel is lib.Model and lib.GraphicalModel.active is gm
        assert lib.get_model() is gm and lib.compat.modelcontext() is gm
        other = lib.GraphicalModel("GM_B")
        assert lib.GraphicalModel.active is other
        gm.activate()
        assert lib.modelcontext() is gm and lib.modelcontext(other) is other
        lib.GraphicalModel.active = None
        assert lib.modelcontext() is None


def test_active_true_joins_one_registry_and_sums_loglikes():
    x, y1 = _sine(14, 5)
    y2 = (0.8 * _sine(14, 6)[1] + 0.1).astype(np.float32)
    out = []
    with floatx("float64"), jax_eager():
        for lib in (g3, g3t):
            lib.GraphicalModel.active = None
            p1 = lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x), name="J1", active=True)
            p2 = lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x), name="J2", active=True)
            p1.observed(x, y1)
            p2.observed(x, y2)
            assert p1.active is p2.active is lib.GraphicalModel.active
            assert p1.active.name == "GM_J1" and p1.active.ndim == 8
            out.append((p1, p2))
        (j1, j2), (t1, t2) = out
        params = nudged(j1.params_default)
        np.testing.assert_allclose(t1.logp(params), j1.logp(params), rtol=1e-10)
        np.testing.assert_allclose(t2.logp(params), t1.logp(params), rtol=1e-12)
        np.testing.assert_allclose(t1.dlogp(params), np.asarray(j1.dlogp(params)),
                                   rtol=1e-10, atol=1e-10)
        # the joint loglike is the sum of the two processes' own
        solo = []
        for y, name in ((y1, "S1"), (y2, "S2")):
            gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name=name)
            gp.observed(x, y)
            solo.append(gp.loglike({k.replace("J1", name).replace("J2", name): v
                                    for k, v in params.items()
                                    if k.startswith("J1" if name == "S1" else "J2")}))
        np.testing.assert_allclose(t1.loglike(params), sum(solo), rtol=1e-12)


def _tutorial08(lib, x):
    """examples/tut08_graphical_models.py's model."""
    gm = lib.GraphicalModel("GM08")
    shared_rate = lib.Param("GM08_shared_rate", shape=(1,), prior=lib.FlatExp())
    p1 = lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(
        x, metric=lib.ARD_L2(x, rate=shared_rate)), name="F1", active=gm)
    p2 = lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(
        x, metric=lib.ARD_L2(x, rate=shared_rate)), name="F2", active=gm)
    return gm, p1, p2


def test_tutorial08_shared_rate_find_map_matches_jax_float64():
    x, y1 = _sine(16, 5)
    y2 = (0.8 * _sine(16, 6)[1] + 0.1).astype(np.float32)
    with floatx("float64"):
        maps = []
        for lib in (g3, g3t):
            gm, p1, p2 = _tutorial08(lib, x)
            p1.observed(x, y1)
            p2.observed(x, y2)
            assert gm.param_names().count("GM08_shared_rate") == 1 and gm.ndim == 7
            np.testing.assert_allclose(p1.logp(), p2.logp(), rtol=1e-12)
            maps.append((p1, p1.find_MAP(points=1, powell=False, display=False)))
        (jp, jmap), (tp, tmap) = maps
        lj = float(jp.logp(jmap))
        assert tp.logp(tmap) > tp.logp() + 1.0
        np.testing.assert_allclose(tp.logp(tmap), lj, rtol=1e-6)
        np.testing.assert_allclose(tp.logp(jmap), lj, rtol=1e-10)
        np.testing.assert_allclose(tmap["GM08_shared_rate"], jmap["GM08_shared_rate"], rtol=1e-3)
        pred = tp.predict(tmap, quantiles=True)
        assert all(np.isfinite(v).all() for v in pred.values())


def test_tutorial03_zoo_runs_on_the_port():
    x, y = _sine(30, 0)
    zoo = {
        "SE": g3t.SE(x), "OU": g3t.OU(x), "MAT32": g3t.MAT32(x), "MAT52": g3t.MAT52(x),
        "RQ": g3t.RQ(x), "SIN": g3t.SIN(x), "SE+LIN": g3t.SE(x) + g3t.LIN(x),
        "SE*SIN": g3t.SE(x) * g3t.SIN(x), "2*SE+1": 2.0 * g3t.SE(x) + 0.1,
    }
    for name, kernel in zoo.items():
        gp = g3t.GP(space=x, location=g3t.Zero(), kernel=kernel,
                    name="K" + name.replace("+", "p").replace("*", "t"))
        gp.observed(x, y)
        assert np.isfinite(gp.logp()) and np.isfinite(gp.dlogp()).all(), name
