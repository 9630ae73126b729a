"""Port parity of the ``Experiment`` model-selection harness
(``g3py_tpu_torch/bayesian/selection.py``) against the JAX package's: the
splits (``new_data``, random and uniform, with a holdout), one simulation
of two models trained with the scipy engine (the selected params within
1e-6 and the scores within 1e-6 relative, float64), the result rows and
``describe``'s pivot, resuming from ``file=`` (a second ``run`` adds no
row), the 'jax', 'iterative' and 'distributed' engines and LOO selection
running through."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import floatx


def _data(n=64):
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0.0, 6.0, n))[:, None]
    y = np.sin(x[:, 0]) + 1.5 + 0.1 * rng.standard_normal(n)
    return x, y


def _models(lib, x, y):
    return [lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x), name="EX_GP"),
            lib.WGP(space=x, location=lib.Bias(), kernel=lib.MAT52(x),
                    mapping=lib.BoxCoxLinear(y), name="EX_WGP")]


@pytest.mark.parametrize("method,holdout", [("random", 0.0), ("random", 0.25),
                                            ("uniform", 0.0)])
def test_splits_match_jax(method, holdout):
    x, y = _data()
    je, te = g3.Experiment(), g3t.Experiment()
    for e in (je, te):
        e.set_data(x, y, p=0.5, limit=0.9, method=method, holdout=holdout)
    for seed in (0, 1):
        for got, want in zip(te.new_data(seed=seed), je.new_data(seed=seed)):
            np.testing.assert_array_equal(got, want)


def test_experiment_run_matches_jax(tmp_path):
    x, y = _data()
    with floatx("float64"):
        runs = {}
        for lib, tag in ((g3, "jax"), (g3t, "port")):
            e = lib.Experiment(models=_models(lib, x, y), file=str(tmp_path / f"{tag}.pkl"))
            e.set_data(x, y, p=0.5)
            e.set_selection(starts=1, points=1, powell=False)
            e.run(n_simulations=1)
            runs[tag] = e
        want, got = runs["jax"].results, runs["port"].results
        assert got.columns == list(want.columns)
        np.testing.assert_array_equal(got["_model"], want["_model"].to_numpy())
        for c in want.columns:
            if c.startswith(("obs_", "test_")):
                np.testing.assert_allclose(got[c].astype(float), want[c].to_numpy(float),
                                           rtol=1e-6, err_msg=c)
            elif c.startswith("EX_"):  # a model's params, NaN in the other's row
                for g, w in zip(got[c], want[c].to_numpy()):
                    np.testing.assert_allclose(np.ravel(g).astype(float),
                                               np.ravel(w).astype(float), rtol=1e-6,
                                               atol=1e-6, err_msg=c)
        pivot = runs["jax"].describe("test_l2")
        mine = runs["port"].describe("test_l2")
        assert mine.columns == ["_simulation"] + list(pivot.columns)
        for m in pivot.columns:
            np.testing.assert_allclose(mine[m], pivot[m].to_numpy(), rtol=1e-6)
        # resume from the file: nothing left to run, no row added
        again = g3t.Experiment(models=_models(g3t, x, y), file=str(tmp_path / "port.pkl"))
        assert len(again.results) == 2 and again.simulations.keys() == {0}
        again.run(n_simulations=1)
        assert len(again.results) == 2


def test_experiment_engines_and_refusals():
    x, y = _data(n=40)
    e = g3t.Experiment(models=_models(g3t, x, y)[:1])
    e.set_data(x, y, p=0.5, holdout=0.25)
    e.set_selection(engine="jax", points=2)
    e.run(n_simulations=1)
    assert np.isfinite(e.results["test_l2"]).all() and "valid_l2" in e.results.columns
    e.set_selection(selection="loo", powell=False)
    e.run(n_simulations=1, repeat=True)
    e.set_selection(engine="iterative", engine_kwargs=dict(rank=8, block=16, cg_iters=30,
                                                           probes=4))
    e.run(n_simulations=1, repeat=True)
    assert len(e.results) == 3 and np.isfinite(e.results["test_l2"]).all()
    with pytest.raises(ValueError):
        e.set_selection(objective="nope")
    # the fused grid skips the (simulation, model) pairs already run, and
    # the plot draws the scores (tests/test_torch_fanout.py holds run_fanout)
    assert len(e.run_fanout(1)) == 3
    e.plot()
    g3t.utils.plots.pyplot().close("all")
    # the band-sharded engine on a mesh of one (no process group;
    # tests/test_torch_distributed_models.py runs it on 2 and 4 ranks)
    e.set_selection(engine="distributed")
    e.run(n_simulations=2)
    assert len(e.results) == 4 and np.isfinite(e.results["test_l2"]).all()
