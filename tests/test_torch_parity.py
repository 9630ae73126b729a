"""Port parity with the reference's own recorded experiment: the sunsets
oracle (GP, WGP1-3, TGP1-3 on the sunspots series, the reference's MAP
params and its recorded scores) replayed through ``g3py_tpu_torch`` at the
JAX package's tolerances (``tests/test_parity_reference.py``), and the
three ``sunspots_gp_*`` golden pins and the six Student-t, transport and
copula pins (``tests/golden.json``).

The port reads the recorded rows from its own JSON copy
(``g3py_tpu_torch/utils/datasets/sunsets_oracle.json``, no pandas); a test
here holds that copy equal to the vendored pickles.  Regenerate it with:

    PYTHONPATH=. python tests/test_torch_parity.py --regen
"""

import json
import os

import numpy as np
import pytest

import g3py_tpu.utils.reference_io as jio
from g3py_tpu.utils.data import data_sunspots as jax_sunspots
import g3py_tpu_torch as g3t
from g3py_tpu_torch.utils import reference_io as tio
from g3py_tpu_torch.utils.data import data_sunspots, datasets_path

import torch_parity  # noqa: F401  (puts the port on the CPU)

HERE = os.path.dirname(os.path.abspath(__file__))
FRAMES = os.path.join(HERE, "data", "experiments", "sunsets.g3x")
ORACLE = os.path.join(datasets_path("sunsets_oracle.json"), "sunsets_oracle.json")
# the JAX test's tolerances (tests/test_parity_reference.py)
TEST_RTOL = 2e-3
NLPD_RTOL = 3e-2
MODELS = ["GP", "WGP1", "WGP2", "WGP3", "TGP1", "TGP2", "TGP3"]
PINS = ("sunspots_gp_logp_ref_map", "sunspots_gp_pred_mean_sum", "sunspots_gp_pred_std_sum")


def _export():
    """The JSON form of the vendored experiment frames: every result row
    (float32 params as exact floats, the float64 score records) and the
    ``obs``/``test`` index arrays of each simulation."""
    results, sims = jio.load_experiment_frames(FRAMES)
    rows = [{"model": str(r["model"]), "n_sim": int(r["n_sim"]),
             "params": {k: np.asarray(v, np.float32).tolist() for k, v in r["params"].items()},
             "scores_obs": {k: float(v) for k, v in r["scores_obs"].items()},
             "scores_test": {k: float(v) for k, v in r["scores_test"].items()}}
            for _, r in results.iterrows()]
    simulations = {str(int(k)): {s: np.asarray(sims.loc[k][s]).astype(int).tolist()
                                 for s in ("obs", "test")} for k in sims.index}
    return {"rows": rows, "simulations": simulations}


def test_oracle_json_matches_frames():
    with open(ORACLE) as fh:
        assert json.load(fh) == _export()
    rows, sims = tio.load_oracle()
    results, frames = jio.load_experiment_frames(FRAMES)
    assert len(rows) == len(results) == 16
    for row, (_, want) in zip(rows, results.iterrows()):
        assert (row["model"], row["n_sim"]) == (want["model"], want["n_sim"])
        assert row["params"].keys() == want["params"].keys()
        for k, v in want["params"].items():
            np.testing.assert_array_equal(row["params"][k], np.asarray(v, np.float32))
        for split in ("scores_obs", "scores_test"):
            assert row[split] == {k: float(v) for k, v in want[split].items()}
    for k in frames.index:
        for split in ("obs", "test"):
            np.testing.assert_array_equal(sims[int(k)][split], frames.loc[k][split])


def test_data_sunspots_matches_jax():
    (x, y), (jx, jy) = data_sunspots(), jax_sunspots()
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype


def test_param_transforms_match_jax():
    rows, _ = tio.load_oracle()
    for row in rows:
        nat = tio.transformed_to_natural(row["params"])
        want = jio.transformed_to_natural(row["params"])
        assert nat.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(nat[k], want[k])
        back, jback = tio.natural_to_transformed(nat), jio.natural_to_transformed(want)
        assert back.keys() == jback.keys()
        for k in jback:
            np.testing.assert_array_equal(back[k], jback[k])


def _build(model_name, x, y):
    """The reference experiment's model zoo: SE kernel + Bias location, the
    mapping varies (as tests/test_parity_reference.py builds it)."""
    common = dict(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name=model_name)
    if model_name == "GP":
        return g3t.GP(**common)
    if model_name.startswith("WGP"):
        return g3t.WGP(mapping=g3t.WarpingTanh(y, n=int(model_name[3:])), **common)
    mapping = {"TGP1": lambda: g3t.BoxCoxLinear(y),
               "TGP2": lambda: g3t.ArcsinhLinear(y),
               "TGP3": lambda: g3t.BoxCoxLinear(y) @ g3t.ArcsinhLinear(y)}[model_name]()
    return g3t.WGP(mapping=mapping, **common)


@pytest.fixture(scope="module")
def oracle():
    rows, sims = tio.load_oracle()
    x, y = data_sunspots()
    return rows, sims, x.astype(np.float32), y.astype(np.float32)


def _unique_rows(rows):
    seen, out = set(), []
    for row in rows:
        key = (row["model"], row["n_sim"],
               tuple(sorted((k, float(np.ravel(v)[0])) for k, v in row["params"].items())))
        if key not in seen:
            seen.add(key)
            out.append(row)
    return out


@pytest.mark.parametrize("model_name", MODELS)
def test_scores_match_reference(oracle, model_name):
    rows, sims, x, y = oracle
    rows = [r for r in _unique_rows(rows) if r["model"] == model_name]
    assert rows, f"no oracle rows for {model_name}"
    sp = _build(model_name, x, y)
    for row in rows:
        obs_j, test_j = sims[row["n_sim"]]["obs"], sims[row["n_sim"]]["test"]
        params = tio.transformed_to_natural(row["params"])
        sp.observed(x[obs_j], y[obs_j])

        sp.set_space(x[test_j], hidden=y[test_j])
        mine = sp.scores(params, logpred=True, bias=True, variance=True)
        ref = row["scores_test"]
        for key in ["_l1", "_l2", "_mse", "_rmse"]:
            assert mine[key] == pytest.approx(ref[key], rel=TEST_RTOL), (
                f"{model_name} n_sim={row['n_sim']} test {key}: mine={mine[key]!r} "
                f"ref={ref[key]!r}")
        assert mine["_nlpd"] == pytest.approx(ref["_nlpd"], rel=NLPD_RTOL), (
            f"{model_name} test _nlpd: mine={mine['_nlpd']!r} ref={ref['_nlpd']!r}")

        sp.set_space(x[obs_j], hidden=y[obs_j])
        mine_obs = sp.scores(params, logpred=True, bias=True, variance=True)
        for key in ["_l1", "_l2", "_mse", "_rmse", "_nlpd"]:
            assert np.isfinite(mine_obs[key]) and mine_obs[key] > -1e29, (
                f"{model_name} obs {key} hit a guard: {mine_obs[key]!r}")
        for key in ["_mse", "_rmse"]:
            assert mine_obs[key] == pytest.approx(row["scores_obs"][key], rel=3.0), (
                f"{model_name} obs {key} off by >4x: mine={mine_obs[key]!r} "
                f"ref={row['scores_obs'][key]!r}")


def test_sunspots_pins_hold_on_port(oracle):
    """The three pins of tests/golden.json, computed as tests/test_golden.py
    computes them (GP, n_sim=0, the reference's MAP), at its tolerance."""
    rows, sims, x, y = oracle
    with open(os.path.join(HERE, "golden.json")) as fh:
        golden = json.load(fh)
    row = rows[1]
    assert (row["model"], row["n_sim"]) == ("GP", 0)
    obs_j, test_j = sims[0]["obs"], sims[0]["test"]
    params = tio.transformed_to_natural(row["params"])
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="GP")
    gp.observed(x[obs_j], y[obs_j])
    gp.set_space(x[test_j], hidden=y[test_j])
    got = {"sunspots_gp_logp_ref_map": gp.logp(params),
           "sunspots_gp_pred_mean_sum": float(gp.mean(params).sum()),
           "sunspots_gp_pred_std_sum": float(gp.std(params).sum())}
    for k in PINS:
        np.testing.assert_allclose(got[k], golden[k], rtol=2e-5, atol=1e-5,
                                   err_msg=f"pin {k}: port {got[k]} vs {golden[k]}")


FAMILY_PINS = ("tp_logp_default", "tp_var_sum", "tp_mean_sum", "tp_dlogp_norm",
               "tgp_logp_default", "cgp_logp_default")


@pytest.fixture(scope="module")
def family_pins():
    """The port's values of the Student-t, transport and copula pins of
    tests/golden.json, on tests/test_golden.py's workloads (float32)."""
    rng = np.random.default_rng(1234)
    x = np.linspace(0, 10, 32).astype(np.float32).reshape(-1, 1)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(32)).astype(np.float32)
    y_pos = (np.exp(0.3 * y) + 1.0).astype(np.float32)
    tp = g3t.TP(space=x, location=g3t.Zero(), kernel=g3t.MAT52(x), name="GOLD_TP")
    tp.observed(x, y)
    tgp = g3t.TGP(space=x, transport=g3t.TLocation(g3t.Bias(x))
                  @ g3t.TKernel(g3t.SE(x), noisy=True), name="GOLD_TGP")
    tgp.observed(x, y)
    cgp = g3t.CGP(space=x, kernel=g3t.SE(x),
                  marginal=g3t.Normal(mu=g3t.Bias(x, name="M"), sigma=g3t.Bias(x, name="S")),
                  name="GOLD_CGP")
    cgp.observed(x, y_pos)
    return {"tp_logp_default": tp.logp(), "tp_var_sum": float(tp.variance().sum()),
            "tp_mean_sum": float(tp.mean().sum()),
            "tp_dlogp_norm": float(np.linalg.norm(tp.dlogp())),
            "tgp_logp_default": tgp.logp(), "cgp_logp_default": cgp.logp()}


@pytest.mark.parametrize("pin", FAMILY_PINS)
def test_family_pins_hold_on_port(family_pins, pin):
    """Each family pin at tests/test_golden.py's 2e-5 / 1e-5."""
    with open(os.path.join(HERE, "golden.json")) as fh:
        want = json.load(fh)[pin]
    np.testing.assert_allclose(family_pins[pin], want, rtol=2e-5, atol=1e-5,
                               err_msg=f"pin {pin}: port {family_pins[pin]} vs {want}")


def test_bo_ucb_pin_holds_on_port():
    """``bo_ucb_suggest_x`` of tests/golden_families.json, on
    tests/test_golden_families.py's workload (float32): a fixed-seed UCB
    suggestion at hand-set hypers, at that file's 5e-5."""
    xb = np.array([[0.4], [1.1], [2.0], [2.9], [3.6]], np.float32)
    yb = np.sin(2.0 * xb[:, 0]).astype(np.float32)
    bgp = g3t.GP(space=xb, location=g3t.Bias(), kernel=g3t.SE(xb), noisy=True, name="GOLD_BO")
    bgp.observed(xb, yb)
    bo = g3t.BayesOpt(bgp, bounds=[[0.0, 4.0]], maximize=True, seed=0)
    pb = dict(bgp.params_default)
    for k in pb:
        if k.endswith("SE_var"):
            pb[k] = np.asarray(1.0, np.float32)
        if k.endswith("Noise_var"):
            pb[k] = np.asarray(1e-4, np.float32)
        if "scales" in k:
            pb[k] = np.asarray(pb[k]) * 0 + 0.5
    got = float(np.ravel(bo.suggest(params=pb, kind="UCB", candidates=256, starts=4,
                                    steps=40))[0])
    with open(os.path.join(HERE, "golden_families.json")) as fh:
        want = json.load(fh)["bo_ucb_suggest_x"]
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5,
                               err_msg=f"pin bo_ucb_suggest_x: port {got} vs {want}")


SSM_PINS = ("ssgp_logp", "ssgp_dlogp_norm", "ssgp_mean_sum", "ssgp_var_sum", "mssgp_logp",
            "mssgp_dlogp_norm", "stssgp_logp")


def _golden_series(n, seed, span=10.0):
    """``tests/test_golden_families.py``'s series."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, n)).reshape(-1, 1).astype(np.float32)
    y = (np.sin(t[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return t, y


@pytest.fixture(scope="module")
def ssm_pins():
    """The port's values of the state-space pins of
    tests/golden_families.json, on tests/test_golden_families.py's
    workloads (float32)."""
    t, y = _golden_series(48, seed=1)
    ss = g3t.StateSpaceGP(space=t, kernel=g3t.MAT32(t) + g3t.OU(t), name="GOLD_SS")
    ss.observed(t, y)
    tq = np.linspace(1, 9, 8).reshape(-1, 1).astype(np.float32)
    t0, y0 = _golden_series(30, seed=2)
    t1, y1 = _golden_series(25, seed=3)
    xm, ym = g3t.stack_outputs([t0, t1], [y0, -0.5 * y1 + 0.3])
    ms = g3t.MultiStateSpaceGP(space=xm, kernel=[g3t.MAT32(t0), g3t.OU(t0)], outputs_dim=2,
                               name="GOLD_MS")
    ms.observed(xm, ym)
    sites = np.array([[0.0], [1.0], [2.5]], np.float32)
    ts, ys = [], []
    for p in range(3):
        tp_, yp = _golden_series(14 + p, seed=4 + p)
        ts.append(tp_)
        ys.append(yp * float(np.exp(-p / 3.0)))
    xs, ysr = g3t.stack_outputs(ts, ys)
    st = g3t.SpatioTemporalSSGP(space=xs, kernel=g3t.MAT32(xs[:, :1]), space_kernel=g3t.SE(sites),
                                sites=sites, name="GOLD_ST")
    st.observed(xs, ysr)
    return {"ssgp_logp": ss.logp(), "ssgp_dlogp_norm": float(np.linalg.norm(ss.dlogp())),
            "ssgp_mean_sum": float(ss.mean(space=tq).sum()),
            "ssgp_var_sum": float(ss.variance(space=tq).sum()),
            "mssgp_logp": ms.logp(), "mssgp_dlogp_norm": float(np.linalg.norm(ms.dlogp())),
            "stssgp_logp": st.logp()}


@pytest.mark.parametrize("pin", SSM_PINS)
def test_state_space_pins_hold_on_port(ssm_pins, pin):
    """Each state-space pin at tests/test_golden_families.py's 5e-5."""
    with open(os.path.join(HERE, "golden_families.json")) as fh:
        want = json.load(fh)[pin]
    np.testing.assert_allclose(ssm_pins[pin], want, rtol=5e-5, atol=5e-5,
                               err_msg=f"pin {pin}: port {ssm_pins[pin]} vs {want}")

if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        with open(ORACLE, "w") as fh:
            json.dump(_export(), fh, separators=(",", ":"))
        print("wrote", ORACLE)
