"""Port parity of the band-sharded linear algebra
(``g3py_tpu_torch/parallel/cholesky.py``) on gloo worlds of D = 1, 2 and 4
CPU ranks (``tests/torch_dist.py``), n = 64, block 8: the band Cholesky,
the forward and transpose band solves, the trainable
``distributed_quad_logdet``/``distributed_gp_nll`` (value and gradient in
the params and y) and ``distributed_posterior``'s four closures.

float64 is held at 1e-10 to the JAX package's single-device x64 algebra
(``jnp.linalg.cholesky``, ``solve_triangular``, ``mvn_quad_logdet`` and its
gradient): the JAX package's band code does not run under x64 (its panel
loop mixes int32 and int64 indices in ``lax.dynamic_slice``; ROADMAP Queue
3), and the band result is the dense one to rounding.  float32 is held at
rtol 1e-4 / atol 1e-5 to the JAX package's band functions on a virtual
mesh of the same D (the factor, the solves and the posterior closures; the
NLL's value and gradient at D = 2, whose compile is ~10 s).  At n = 256
no rank makes an n x n tensor in the NLL's forward or backward."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.scipy.linalg import solve_triangular

from g3py_tpu.ops.linalg import mvn_quad_logdet
from g3py_tpu.parallel import make_mesh, cholesky as jchol

from torch_dist import world
from torch_parity import F32_TOL, floatx

N, BLOCK, DS, N_PEAK = 64, 8, (1, 2, 4), 256
PARAMS = {"var": 1.3, "ls": 0.8, "nv": 0.1}
WQ, WL = 0.3, 0.7


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, 2))
    return x, rng.normal(size=N), rng.normal(size=(N, 3)), rng.normal(size=(5, 2))


def jcov(p, a, b):
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return p["var"] * jnp.exp(-0.5 * d2 / p["ls"] ** 2)


def _gram(x):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return PARAMS["var"] * np.exp(-0.5 * d2 / PARAMS["ls"] ** 2) + PARAMS["nv"] * np.eye(N)


def _tasks():
    x, y, b, xq = _data()
    k = _gram(x)
    tasks = []
    for fx in ("float64", "float32"):
        tasks += [(f"algebra_{fx}", "band_algebra", dict(k=k, b=b, block=BLOCK, floatx=fx)),
                  (f"objective_{fx}", "objective",
                   dict(x=x, y=y, params=PARAMS, block=BLOCK, wq=WQ, wl=WL, floatx=fx)),
                  (f"posterior_{fx}", "posterior",
                   dict(x=x, resid=y, xq=xq, params=PARAMS, rhs=b, block=BLOCK, floatx=fx))]
    rng = np.random.default_rng(1)  # n = 256: above K2's 128-wide padded tile
    return tasks + [("peak", "peak", dict(x=rng.normal(size=(N_PEAK, 2)),
                                          y=rng.normal(size=N_PEAK), params=PARAMS,
                                          block=32))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank's results at D = 1, 2, 4 (the three worlds at once)."""
    base = tmp_path_factory.mktemp("parallel_cholesky")
    with concurrent.futures.ThreadPoolExecutor(len(DS)) as pool:
        runs = {d: pool.submit(world, d, _tasks(), base) for d in DS}
        return {d: r.result() for d, r in runs.items()}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's dense x64 algebra and the gradient of its
    ``mvn_quad_logdet`` objective."""
    x, y, b, xq = _data()
    k = _gram(x)
    with floatx("float64"):
        l = np.asarray(jnp.linalg.cholesky(k))
        p = {kk: jnp.asarray(v) for kk, v in PARAMS.items()}

        def parts(p, yy):
            gram = jcov(p, x, x) + p["nv"] * jnp.eye(N)
            quad, ld, _ = mvn_quad_logdet(gram, yy)
            return quad, ld

        def nll(p, yy):
            quad, ld = parts(p, yy)
            return 0.5 * quad + ld + 0.5 * N * np.float32(np.log(2 * np.pi))

        qld = jax.jit(jax.value_and_grad(lambda p, yy: (lambda q: WQ * q[0] + WL * q[1])(
            parts(p, yy)), argnums=(0, 1)))
        nllg = jax.jit(jax.value_and_grad(nll, argnums=(0, 1)))
        quad, ld = (float(v) for v in jax.jit(parts)(p, jnp.asarray(y)))
        kq = np.asarray(jcov(p, x, xq))
        alpha = np.linalg.solve(k, y)
        w = np.linalg.solve(l, kq)
        out = {"l": l, "z": np.asarray(solve_triangular(l, b, lower=True)),
               "zt": np.asarray(solve_triangular(l.T, b, lower=False)),
               "quad": quad, "logdet_half": ld, "qld": qld(p, jnp.asarray(y)),
               "nll": nllg(p, jnp.asarray(y)), "alpha": alpha, "mean_delta": kq.T @ alpha,
               "var_red": (w * w).sum(0), "solve": np.linalg.solve(k, b),
               "apply": np.asarray(jcov(p, xq, x)) @ np.linalg.solve(k, b)}
    return out


def _whole(results, key, field):
    """The rank bands of ``field`` stacked in rank order."""
    return np.concatenate([r[key][field] for r in results])


def _grads(vg):
    value, (gp, gy) = vg
    return float(value), {**{k: float(v) for k, v in gp.items()}, "y": np.asarray(gy)}


@pytest.mark.parametrize("d", DS)
def test_band_factor_and_solves_match_x64(worlds, reference, d):
    res = worlds[d]
    assert all(r["algebra_float64"]["l"].shape == (N // d, N) for r in res)
    for field in ("l", "z", "zt"):
        np.testing.assert_allclose(_whole(res, "algebra_float64", field), reference[field],
                                   rtol=1e-10, atol=1e-10, err_msg=field)


@pytest.mark.parametrize("d", DS)
def test_band_factor_and_solve_match_jax_bands_float32(worlds, d):
    x, _, b, _ = _data()
    k = _gram(x).astype(np.float32)
    mesh = make_mesh(n_devices=d)
    with floatx("float32"):
        l = jchol.distributed_cholesky(k, mesh=mesh, block=BLOCK)
        z = jchol.distributed_trsm(l, b.astype(np.float32), mesh=mesh, block=BLOCK)
    np.testing.assert_allclose(_whole(worlds[d], "algebra_float32", "l"), np.asarray(l),
                               **F32_TOL)
    np.testing.assert_allclose(_whole(worlds[d], "algebra_float32", "z"), np.asarray(z),
                               **F32_TOL)


@pytest.mark.parametrize("d", DS)
def test_quad_logdet_and_nll_match_x64(worlds, reference, d):
    """Value and gradient (the params and y; the parameter cotangent summed
    over the ranks) of both objectives, the same on every rank."""
    for r in worlds[d]:
        got = r["objective_float64"]
        np.testing.assert_allclose(got["quad"], reference["quad"], rtol=1e-10)
        np.testing.assert_allclose(got["logdet_half"], reference["logdet_half"], rtol=1e-10)
        for key in ("qld", "nll"):
            value, grads = _grads(reference[key])
            np.testing.assert_allclose(got[key], value, rtol=1e-10, err_msg=key)
            for name, want in grads.items():
                np.testing.assert_allclose(got[key + "_grad"][name], want, rtol=1e-10,
                                           atol=1e-10, err_msg=f"{key} d{name}")
        # the psummed values are bit-equal on every rank
        np.testing.assert_array_equal(got["nll_grad"]["y"],
                                      worlds[d][0]["objective_float64"]["nll_grad"]["y"])


def test_nll_matches_jax_band_float32(worlds):
    """The JAX package's band NLL on a 2-device mesh, value and gradient,
    against the port's at every D in float32."""
    x, y, _, _ = _data()
    with floatx("float32"):
        nll = jchol.distributed_gp_nll(jcov, mesh=make_mesh(n_devices=2), block=BLOCK,
                                       noise_fn=lambda p: p["nv"])
        p = {k: jnp.float32(v) for k, v in PARAMS.items()}
        value, grads = _grads(jax.jit(jax.value_and_grad(nll, argnums=(0, 2)))(
            p, jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)))
    for d in DS:
        got = worlds[d][0]["objective_float32"]
        np.testing.assert_allclose(got["nll"], value, **F32_TOL)
        for name, want in grads.items():
            np.testing.assert_allclose(got["nll_grad"][name], want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"d={d} d{name}")


@pytest.mark.parametrize("d", DS)
def test_posterior_closures_match(worlds, reference, d):
    """state_fn's bands (L, alpha), query_fn's psums, solve_fn's band and
    apply_fn's product: float64 against the dense x64 algebra, float32
    against the JAX package's closures on a mesh of the same D."""
    res = worlds[d]
    np.testing.assert_allclose(_whole(res, "posterior_float64", "l"), reference["l"],
                               rtol=1e-10, atol=1e-10)
    for field in ("alpha", "solve"):
        np.testing.assert_allclose(_whole(res, "posterior_float64", field), reference[field],
                                   rtol=1e-9, atol=1e-10, err_msg=field)
    for field in ("mean_delta", "var_red", "apply"):
        for r in res:  # replicated: every rank's is the whole
            np.testing.assert_allclose(r["posterior_float64"][field], reference[field],
                                       rtol=1e-9, atol=1e-10, err_msg=field)
    x, y, b, xq = _data()
    with floatx("float32"):
        state_fn, query_fn, solve_fn, apply_fn = jchol.distributed_posterior(
            jcov, mesh=make_mesh(n_devices=d), block=BLOCK, noise_fn=lambda p: p["nv"])
        p = {k: jnp.float32(v) for k, v in PARAMS.items()}
        x32, xq32 = x.astype(np.float32), xq.astype(np.float32)
        l, alpha = state_fn(p, x32, y.astype(np.float32))
        md, vr = query_fn(p, x32, l, alpha, xq32)
        a = solve_fn(l, b.astype(np.float32))
        want = {"alpha": alpha, "mean_delta": md, "var_red": vr, "solve": a,
                "apply": apply_fn(p, x32, xq32, a)}
    got = res[0]["posterior_float32"]
    for field in ("mean_delta", "var_red", "apply"):
        np.testing.assert_allclose(got[field], np.asarray(want[field]), rtol=1e-4, atol=1e-4,
                                   err_msg=field)
    for field in ("alpha", "solve"):
        np.testing.assert_allclose(_whole(res, "posterior_float32", field),
                                   np.asarray(want[field]), rtol=1e-4, atol=1e-4,
                                   err_msg=field)


@pytest.mark.parametrize("d", [2, 4])
def test_no_rank_holds_the_whole_gram(worlds, d):
    """Every tensor a rank makes in the NLL's forward and backward: none
    has two axes of n, none is larger than the (n/D, n) band times the
    input width (the band gram's pairwise differences), and the band is
    there."""
    n = N_PEAK
    for r in worlds[d]:
        assert not [s for s in r["peak"] if list(s).count(n) >= 2], r["peak"]
        assert max(int(np.prod(s)) for s in r["peak"]) <= 2 * n * n // d
        assert (n // d, n) in r["peak"]
