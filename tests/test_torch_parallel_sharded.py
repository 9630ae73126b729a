"""Port parity of the sharded wrappers (``g3py_tpu_torch/parallel/
sharded.py``) and the sharded fan-out on gloo worlds of D = 1, 2 and 4
CPU ranks (``tests/torch_dist.py``):

* ``sharded_logp_fn``: the posterior logp over row bands (value and
  gradient) against the JAX package's sharded logp (x64, 1e-10) and the
  port's single-device logp;
* ``sharded_ensemble_step``: three walker-split stretch iterations fed the
  JAX package's draws (its key splits, as ``tests/test_torch_samplers.py``
  feeds them) against its sharded step, 1e-10 in float64;
* ``pt_sampler_sharded``: one temperature a rank, 10 rounds, the moves and
  the exchange uniforms fed from the JAX package's ``fold_in`` streams,
  against its chain in float32;
* ``lbfgs_fanout_sharded`` and ``fit_splits(shard=True)`` against the
  unsharded fan-out."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.bayesian import samplers as jsam
from g3py_tpu.parallel import make_mesh, sharded as jsh

from torch_dist import world
from torch_dist_work import MU, SCALE, build, quadratic_obj
from torch_parity import F32_TOL, floatx, nudged

DS, CHAINS, STEPS, ROUNDS = (1, 2, 4), 8, 3, 10


def _jlogp(p):
    return -0.5 * jnp.sum(((p - MU) / SCALE) ** 2)


def _jprior(p):
    return -0.05 * jnp.sum(p ** 2)


def _half_draws(key, n, dtype):
    k1, k2, k3 = random.split(key, 3)
    return (np.asarray(random.uniform(k1, (n,), dtype=dtype)),
            np.asarray(random.randint(k2, (n,), 0, n)),
            np.asarray(jnp.log(random.uniform(k3, (n,), dtype=dtype))))


def _gp_data(n=24, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 6.0, (n, 1))
    return x, np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)


def _ensemble_draws():
    """The JAX sharded step's draws: each key splits into the two halves'."""
    keys = random.split(random.PRNGKey(11), STEPS)
    out = []
    for k in keys:
        k1, k2 = random.split(k)
        out += [_half_draws(k1, CHAINS // 2, jnp.float64),
                _half_draws(k2, CHAINS // 2, jnp.float64)]
    return keys, out


def _pt_draws(ntemps):
    """Per rank, its move draws in order; the exchange uniforms by (round,
    pair) — the JAX package's ``fold_in(key, rank)`` / ``fold_in(key,
    pair)`` streams."""
    keys = random.split(random.PRNGKey(0), ROUNDS)
    halves = {me: [] for me in range(ntemps)}
    pairs = {}
    for r, k in enumerate(keys):
        for me in range(ntemps):
            k_move, _ = random.split(random.fold_in(k, me))
            k1, k2 = random.split(k_move)
            halves[me] += [_half_draws(k1, CHAINS // 2, jnp.float32),
                           _half_draws(k2, CHAINS // 2, jnp.float32)]
        for pair in range(ntemps - 1):
            pairs[r, pair] = np.asarray(random.uniform(random.fold_in(k, pair), (CHAINS,),
                                                       dtype=jnp.float32))
    return halves, pairs


def _p0(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def _masks():
    targets = np.arange(6, dtype=np.float64)[:, None] * np.array([[1.0, -0.5]])
    return np.zeros((6, 2)) + np.array([[3.0, 1.0]]), np.concatenate(
        [targets, np.zeros((6, 3))], axis=1)


def _split_masks():
    x, _ = _gp_data()
    rng = np.random.default_rng(6)
    return (rng.uniform(size=(3, len(x))) < 0.7).astype(np.float64)


def _gp_params():
    x, y = _gp_data()
    with floatx("float64"):
        return nudged(build(g3, "gp", x, y, "SH_GP").params_default)


def _tasks(d):
    x, y = _gp_data()
    with floatx("float64"):
        u = np.asarray(build(g3, "gp", x, y, "SH_GP").active.dict_to_array(_gp_params()))
        _, halves = _ensemble_draws()
    with floatx("float32"):
        pt_halves, pairs = _pt_draws(d)
    starts, masks = _masks()
    return [("logp", "logp_sharded", dict(kind="gp", x=x, y=y, name="SH_GP", u=u)),
            ("ensemble", "ensemble", dict(p0=_p0(1, (CHAINS, 3)), halves=halves, steps=STEPS)),
            ("pt", "pt", dict(p0=_p0(2, (d, CHAINS, 3)), samples=ROUNDS, halves=pt_halves,
                              pairs=pairs, floatx="float32")),
            ("fanout", "fanout", dict(starts=starts, masks=masks)),
            ("splits", "splits", dict(kind="gp", x=x, y=y, name="SH_FIT", masks=_split_masks(),
                                      pair_chunk=None)),
            ("splits_chunked", "splits", dict(kind="gp", x=x, y=y, name="SH_FIT",
                                              masks=_split_masks(), pair_chunk=4))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("parallel_sharded")
    with concurrent.futures.ThreadPoolExecutor(len(DS)) as pool:
        runs = {d: pool.submit(world, d, _tasks(d), base) for d in DS}
        return {d: r.result() for d, r in runs.items()}


@pytest.mark.parametrize("d", DS)
def test_sharded_logp_matches_jax(worlds, d):
    x, y = _gp_data()
    with floatx("float64"):
        jp = build(g3, "gp", x, y, "SH_GP")
        fn, place = jsh.sharded_logp_fn(jp, mesh=make_mesh(n_devices=d))
        u = jnp.asarray(jp.active.dict_to_array(_gp_params()))
        v, g = jax.value_and_grad(fn)(u, *place(jp.space, jp.inputs, jp.outputs))
    for r in worlds[d]:
        got = r["logp"]
        assert got["rows"] == len(x) // d
        np.testing.assert_allclose(got["logp"], float(v), rtol=1e-10)
        np.testing.assert_allclose(got["logp"], got["single"], rtol=1e-10)
        np.testing.assert_allclose(got["grad"], np.asarray(g), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("d", DS)
def test_sharded_ensemble_step_matches_jax(worlds, d):
    keys, _ = _ensemble_draws()
    with floatx("float64"):
        step, place, logp_vm = jsh.sharded_ensemble_step(
            _jlogp, mesh=make_mesh(n_devices=d, axis_names=("chains",)))
        x = place(_p0(1, (CHAINS, 3)))
        lp = logp_vm(x)
        for k in keys:
            x, lp = step(k, x, lp)
    for r in worlds[d]:
        np.testing.assert_allclose(r["ensemble"]["x"], np.asarray(x), rtol=1e-10, atol=1e-10)
        assert r["ensemble"]["local"].shape == (CHAINS // d, 3)
    assert (np.asarray(x) != _p0(1, (CHAINS, 3))).any()


@pytest.mark.parametrize("d", DS)
def test_pt_sampler_sharded_matches_jax(worlds, d):
    with floatx("float32"):
        want = jsh.pt_sampler_sharded(_jlogp, _jprior, _p0(2, (d, CHAINS, 3)), ROUNDS,
                                      mesh=make_mesh(n_devices=d, axis_names=("temps",)),
                                      axis="temps", key=0)
    for r in worlds[d]:
        assert r["pt"]["left"] == 0
        assert r["pt"]["chain"].shape == (CHAINS, ROUNDS, 3)
        np.testing.assert_allclose(r["pt"]["chain"], want, **F32_TOL)


@pytest.mark.parametrize("d", DS)
def test_fanout_sharded_matches_the_fanout(worlds, d):
    starts, masks = _masks()
    with floatx("float64"):
        pts, vals = g3t.lbfgs_fanout(quadratic_obj, starts, masks, max_iters=50, tol=1e-9)
        x, y = _gp_data()
        proc = build(g3t, "gp", x, y, "SH_FIT")
        _, fvals, fpts = g3t.fit_splits(proc, _split_masks(), points=2, max_iters=100,
                                        tol=1e-8, return_points=True)
    for r in worlds[d]:
        np.testing.assert_allclose(r["fanout"]["pts"], pts, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(r["fanout"]["vals"], vals, rtol=1e-10, atol=1e-12)
        for key in ("splits", "splits_chunked"):
            np.testing.assert_allclose(r[key]["vals"], fvals, rtol=1e-8, err_msg=key)
            np.testing.assert_allclose(r[key]["pts"], fpts, rtol=1e-6, atol=1e-8, err_msg=key)


def test_mesh_of_one_without_a_process_group():
    """Without a process group a mesh is a mesh of one: no collective runs,
    the layouts keep every row, and a mesh of another size is refused."""
    from g3py_tpu_torch.parallel import mesh as tmesh

    m = g3t.parallel.make_mesh()
    assert m.shape == {"dp": 1} and m.devices.shape == (1,) and m.backend is None
    t = torch.arange(6.0).reshape(3, 2)
    for op in (tmesh.psum, tmesh.all_gather, tmesh.gather_rows):
        assert op(m, t) is t
    assert tmesh.permute(m, t, 1) is t
    with floatx("float64"):
        placed = g3t.parallel.data_sharding(m).place(t.numpy())
        np.testing.assert_array_equal(placed.numpy(), t.numpy())
        np.testing.assert_array_equal(g3t.parallel.replicate(m).place(t.numpy()).numpy(),
                                      t.numpy())
    with pytest.raises(ValueError, match="process group has 1 rank"):
        g3t.parallel.make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="does not lay out"):
        g3t.parallel.make_mesh(axis_names=("a", "b"), shape=(1, 2))
