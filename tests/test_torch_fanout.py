"""Port parity of the fused split-training grid: the masked loglikes of the
GP and Student-t families (``th_loglike_masked_fn``) against the JAX
package's, values and gradients over several masks with row-varying params
(float64 at 1e-10, float32 at the f32 floor); the masked-equals-subset
identity; ``lbfgs_maximize``'s rows payload (each row evaluated with its own
mask however the line searches subset them); ``fit_splits``'s per-split
optimum against the JAX package's on one tiny grid (the optimum, not the
iterates: value 1e-6 relative, params 1e-4); one batched K1 and one batched
K2 call an evaluation; and ``Experiment.run_fanout``'s rows and resume."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import KernelSpy, assert_close, floatx, jax_compiled, nudged, process_pair

N = 16


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 6.0, n)).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n) + 1.5
    masks = (rng.random((3, n)) < 0.6).astype(np.float64)
    masks[:, :2] = 1.0  # every split holds a few points
    return x, y, masks


FAMILIES = {
    "gp": lambda lib, x: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x), name="FAN_GP"),
    "wgp": lambda lib, x: lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                  mapping=lib.BoxCoxShifted(), name="FAN_WGP"),
    "tp": lambda lib, x: lib.TP(space=x, location=lib.Bias(), kernel=lib.SE(x), name="FAN_TP"),
}


def _rows(jp, masks):
    """Three params rows, each nudged off the defaults by its own factor."""
    return np.stack([jp.active.dict_to_array(nudged(jp.params_default, f))
                     for f in (0.05, 0.1, 0.2)])[:len(masks)]


def _jax_masked(jp, x, y, u, masks):
    """The JAX package's masked loglike and its gradient in the
    unconstrained rows, one compiled program over the rows."""
    reg, like = jp.active, jp.th_loglike_masked_fn()

    def one(ui, wi):
        return like(reg.array_to_dict_jax(ui), jnp.asarray(x), jnp.asarray(y), wi)

    fn = jax.vmap(jax.value_and_grad(one))
    v, g = jax_compiled(fn, jnp.asarray(u), jnp.asarray(masks))
    return np.asarray(v), np.asarray(g)


def _torch_masked(tp, x, y, u, masks):
    reg, like = tp.active, tp.th_loglike_masked_fn()
    ut = torch.as_tensor(u).requires_grad_(True)
    v = like(reg.array_to_dict_tensor(ut), torch.as_tensor(x), torch.as_tensor(y),
             torch.as_tensor(masks))
    (g,) = torch.autograd.grad(v.sum(), ut)
    return v.detach().numpy(), g.numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("name", ["float64", "float32"])
def test_masked_loglike_matches_jax(family, name):
    x, y, masks = _data()
    with floatx(name):
        jp, tp = process_pair(lambda lib: FAMILIES[family](lib, x), x, y)
        u = _rows(jp, masks).astype(name)
        w, xs, ys = masks.astype(name), x.astype(name), y.astype(name)
        want = _jax_masked(jp, xs, ys, u, w)
        got = _torch_masked(tp, xs, ys, u, w)
    assert np.all(np.isfinite(want[0])) and want[0].max() > -1e29
    assert_close(got, want, name, err_msg=family)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_masked_equals_the_subset_loglike(family):
    """The masked loglike of a split is the loglike of the process observed
    on the split's points alone."""
    x, y, masks = _data()
    for name in ("float64", "float32"):
        with floatx(name):
            tp = FAMILIES[family](g3t, x)
            tp.observed(x, y)
            u = _rows(tp, masks)
            got = _torch_masked(tp, x, y, u, masks)[0]
            for r, w in enumerate(masks):
                sub = FAMILIES[family](g3t, x)
                keep = w.astype(bool)
                sub.observed(x[keep], y[keep])
                want = sub.loglike(tp.active.array_to_dict(u[r]))
                np.testing.assert_allclose(got[r], want, rtol=1e-10 if name == "float64"
                                           else 1e-4, err_msg=f"{family} {name} row {r}")


def test_rows_payload_keeps_each_rows_mask():
    """A quadratic objective whose optimum depends on the mask row: each of
    the 6 pairs reaches its own optimum, however the line searches subset
    the rows, and ``find_MAP(engine='jax')``'s objective sees no payload."""
    targets = np.arange(6, dtype=np.float64)[:, None] * np.array([[1.0, -0.5]])
    masks = np.concatenate([targets, np.zeros((6, 3))], axis=1)
    seen = []

    def obj(u, w):
        seen.append(len(u))
        scale = 1.0 + torch.arange(1, 3, dtype=u.dtype) * (1.0 + w[:, :1].abs())
        return -(scale * (u - w[:, :2]) ** 2).sum(-1)

    with floatx("float64"):
        starts = np.zeros((6, 2)) + np.array([[3.0, 1.0]])
        pts, vals = g3t.lbfgs_fanout(obj, starts, masks, max_iters=50, tol=1e-9)
    np.testing.assert_allclose(pts, targets, atol=1e-7)
    np.testing.assert_allclose(vals, 0.0, atol=1e-12)
    assert min(seen) < 6  # some evaluations held a subset of the rows


def test_fit_splits_optimum_matches_jax(monkeypatch):
    x, y, masks = _data(n=12, seed=3)
    masks = masks[:2]
    with floatx("float64"):
        jp, tp = process_pair(lambda lib: FAMILIES["gp"](lib, x), x, y)
        want_p, want_v = jp.fit_splits(masks, points=2, max_iters=200, tol=1e-8)
        spy = KernelSpy(monkeypatch)
        got_p, got_v = tp.fit_splits(masks, points=2, max_iters=200, tol=1e-8)
        evals = g3t.lbfgs_maximize.evaluations
        # one batched K1 gram and one batched K2 factorization an evaluation
        assert spy.take() == (evals, evals)
        # the pairs split over a mesh of one (no process group): the same fits
        sharded_p, sharded_v = tp.fit_splits(masks, points=2, max_iters=200, tol=1e-8,
                                             shard=True)
    np.testing.assert_allclose(got_v.max(axis=1), np.asarray(want_v).max(axis=1), rtol=1e-6)
    for g, w in zip(got_p, want_p):
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    # (tests/test_torch_parallel_sharded.py splits the pairs over 2 and 4 ranks)
    np.testing.assert_array_equal(sharded_v, got_v)
    for g, s in zip(got_p, sharded_p):
        for k in g:
            np.testing.assert_array_equal(np.asarray(s[k]), np.asarray(g[k]), err_msg=k)


def test_run_fanout_rows_and_resume(tmp_path):
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 6, 40)).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(40)
    with floatx("float64"):
        gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="FAN_E1")
        tp = g3t.TP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="FAN_E2")
        e = g3t.Experiment(models=[gp, tp], file=str(tmp_path / "e.pkl"))
        e.set_data(x, y, p=0.5, holdout=0.25)
        e.set_selection(starts=2)
        res = e.run_fanout(n_simulations=2, max_iters=60)
        assert len(res) == 4 and sorted(set(res["_model"].tolist())) == ["FAN_E1", "FAN_E2"]
        cols = [c for c in res.columns if c.startswith(("obs_", "valid_", "test_", "time_"))]
        assert {"obs_l2", "valid_l2", "test_l2", "time_params"} <= set(cols)
        for col in cols:
            assert np.all(np.isfinite(np.asarray(res[col], dtype=float))), col
        # the splits are run()'s
        np.testing.assert_array_equal(e.simulations[1][2], e.new_data(seed=1)[2])
        # resume: a second call adds no row, a new experiment reads the file
        assert len(e.run_fanout(n_simulations=2)) == 4
        again = g3t.Experiment(models=[gp, tp], file=str(tmp_path / "e.pkl"))
        assert len(again.run_fanout(n_simulations=2)) == 4
        assert len(e.run_fanout(n_simulations=1, repeat=True)) == 6
