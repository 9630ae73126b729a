"""Port parity of the SGPR family (``models/sparse.py``) against the JAX
package: the collapsed bound of SGP and SWGP (logp, dlogp through the
trainable inducing inputs, the masked bound, the tiny-noise penalty of the
V-parametrization), the sparse posterior moments and covariance, the
serving state (``predictor``, ``updated``, the pathwise draws from the JAX
package's injected normals, ``batch_predict`` over rows), ``fit_svgp``
(Adam and ``natgrad``, full batch and the JAX package's minibatch indices
injected), ``select_inducing``'s own k-means against scikit-learn's,
``signal_kernel_diag``'s two routes, and batched rows: one K1 launch a gram
and one K2 launch a factorization for all rows.  float64 against JAX x64
at 1e-10 (fit_svgp's loss trajectories at 1e-8), float32 at rtol 1e-4 /
atol 1e-5."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu.models.sparse import signal_kernel_diag as j_diag
from g3py_tpu_torch.models.sparse import signal_kernel_diag as t_diag

from test_torch_rff import jax_draws
from torch_parity import (KernelSpy, assert_close, floatx, jax_logp_dlogp, nudged,
                          process_pair)


def _data(n=48, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 6.0, (n, d))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1] + 0.1 * rng.standard_normal(n)
    xq = rng.uniform(-0.5, 6.5, (7, d))
    return x, y, xq


def _z(x, m=6):
    """Well-separated explicit inducing inputs (a subset of the data)."""
    return x[np.linspace(0, len(x) - 1, m).astype(int)] + 0.01


def _build(kind, x, z, name):
    def build(lib):
        if kind == "swgp":
            return lib.SWGP(space=x[:4], location=lib.Bias(), kernel=lib.SE(x),
                            mapping=lib.BoxCoxLinear(np.abs(x[:, 0]) + 1.0), inducing=z,
                            name=name)
        return lib.SGP(space=x[:4], location=lib.Bias(), kernel=lib.SE(x), inducing=z,
                       name=name)
    return build


@pytest.mark.parametrize("kind", ["sgp", "swgp"])
def test_collapsed_bound_and_moments_match_jax(kind):
    """logp, dlogp (the inducing inputs a trained Param), predict's noisy
    statistics and the posterior covariance, and the predictor's fused
    statistics (latent and noisy, with the quantile bands)."""
    x, y, xq = _data()
    y = np.abs(y) + 1.0 if kind == "swgp" else y
    with floatx("float64"):
        jp, tp = process_pair(_build(kind, x, _z(x), "SP" + kind), x, y)
        assert [p.name for p in tp.active.ordered_params] == \
            [p.name for p in jp.active.ordered_params]
        assert tp.active.params_spec["SP%s_Inducing_z" % kind].shape == (6, 2)
        params = nudged(jp.params_default)
        logp, dlogp = jax_logp_dlogp(jp, params)
        assert_close(tp.logp(params), logp, "float64", err_msg="logp")
        assert_close(tp.dlogp(params), dlogp, "float64", err_msg="dlogp")
        if kind == "sgp":  # the statistics one by one (the predictor's are fused)
            want = jp.predict(params, xq, mean=True, std=True, var=True, noise=True)
            got = tp.predict(params, xq, mean=True, std=True, var=True, noise=True)
            assert_close(dict(got), {k: np.asarray(v) for k, v in want.items()}, "float64",
                         err_msg="predict")
            assert_close(tp.covariance(params, xq, noise=True),
                         jp.covariance(params, xq, noise=True), "float64", err_msg="cov")
        jpr = jp.predictor(params)
        tpr = tp.predictor(g3t.params_from_jax(tp, params))
        flags = dict(mean=True, std=True, var=True, quantiles=True, quantiles_noise=True)
        want = jpr(xq, **flags)
        assert_close(dict(tpr(xq, **flags)), {k: np.asarray(v) for k, v in want.items()},
                     "float64", err_msg="predictor")


def test_collapsed_bound_float32_and_masked_bound():
    x, y, _ = _data()
    with floatx("float32"):
        jp, tp = process_pair(_build("sgp", x, _z(x), "SP32"), x, y)
        params = nudged(jp.params_default)
        logp, dlogp = jax_logp_dlogp(jp, params)
        assert_close(tp.logp(params), logp, "float32")
        assert_close(tp.dlogp(params), dlogp, "float32")
    w = (np.arange(len(x)) % 3 != 0).astype(float)
    with floatx("float64"):
        jp, tp = process_pair(_build("sgp", x, _z(x), "SPm"), x, y)
        params = nudged(jp.params_default)
        want = jax.jit(jp.th_loglike_masked_fn())({k: jnp.asarray(v) for k, v in params.items()},
                                                  jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
        pt = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
        got = tp.th_loglike_masked_fn()(pt, torch.as_tensor(x), torch.as_tensor(y), w)
        assert_close(got, want, "float64")
        # the masked bound is the bound of the included rows
        keep = w > 0
        sub = g3t.SGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), inducing=_z(x),
                      name="SPm")
        sub.observed(x[keep], y[keep])
        np.testing.assert_allclose(float(got), sub.loglike(params), rtol=1e-10)


def test_tiny_noise_is_penalized_not_exploited():
    """The V-parametrization's penalty (the JAX package's
    ``test_tiny_noise_is_penalized_not_exploited``) holds on the port in
    float32, at the JAX package's values: the bound falls by more than 100
    nats as the noise variance goes to 1e-6, 1e-10 and 0."""
    rng = np.random.default_rng(0)
    n = 120
    x = np.sort(rng.uniform(0, 8, n)).astype(np.float32).reshape(-1, 1)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)

    def build(lib):
        return lib.SGP(space=x, location=lib.Bias(), kernel=lib.SE(x), inducing=8,
                       learn_inducing=False, name="TNz")

    with floatx("float32"):
        jp, tp = process_pair(build, x, y)
        np.testing.assert_array_equal(tp.f_inducing.z_fixed, jp.f_inducing.z_fixed)
        p = dict(jp.params_default)
        base = tp.loglike(p)
        assert_close(base, jp.loglike(p), "float32")
        for nv in (1e-6, 1e-10, 0.0):
            p["TNz_Noise_var"] = np.float32(nv)
            ll, want = tp.loglike(p), jp.loglike(p)
            assert ll < base - 100, (nv, ll, base)
            np.testing.assert_allclose(ll, want, rtol=1e-4)


def test_rows_are_one_batched_call(monkeypatch):
    """A (R, ndim) matrix of rows: its logps and gradients equal the single
    rows' (and the JAX package's), from one K1 launch a gram (Kuu, Kuf) and
    one K2 launch a factorization (Kuu, B~) — the diagonal takes none."""
    x, y, _ = _data()
    with floatx("float64"):
        jp, tp = process_pair(_build("sgp", x, _z(x), "SPr"), x, y)
        u0 = np.asarray(jp.active.dict_to_array(nudged(jp.params_default)))
        rows = u0[None, :] * (1.0 + 0.05 * np.random.default_rng(1).standard_normal((4, 1)))
        spy = KernelSpy(monkeypatch)
        got = tp.logp_chain(rows)
        assert spy.take() == (2, 2)
        vals, grads = tp._rows_value_and_grad(torch.as_tensor(rows))
        assert spy.take() == (2, 2)
        singles = [tp.logp(r, array=True) for r in rows]
        np.testing.assert_allclose(got, singles, rtol=1e-12)
        np.testing.assert_allclose(vals.numpy(), singles, rtol=1e-12)
        for r, g in zip(rows, grads.numpy()):
            np.testing.assert_allclose(g, tp.dlogp(r), rtol=1e-10, atol=1e-10)
        assert_close(got, jp.logp_chain(rows), "float64")
        # batch_predict over rows: one batched state, each row its single's
        xq = x[:5] + 0.1
        batch = tp._batch_statistics(rows, xq, None, None)
        for i, r in enumerate(rows):
            single = tp.predictor(tp.active.array_to_dict(r))(xq)
            np.testing.assert_allclose(batch["mean"][i].numpy(), single["mean"],
                                       rtol=1e-10)
            np.testing.assert_allclose(batch["std"][i].numpy(), single["std"],
                                       rtol=1e-10)


def test_predictor_updated_and_pathwise_match_jax():
    """``updated`` (the O(m^2) streaming update) against the JAX package's
    and against a fresh state on the concatenated data; the SGPR pathwise
    draws from the JAX package's normals (the RFF block, xi, the output
    noise rebuilt from its key splits)."""
    x, y, xq = _data(n=60)
    z = _z(x)
    with floatx("float64"):
        jp, tp = process_pair(_build("sgp", x[:44], z, "SPu"), x[:44], y[:44])
        params = nudged(jp.params_default)
        jpr = jp.predictor(params).updated(x[44:], y[44:])
        tpr = tp.predictor(g3t.params_from_jax(tp, params)).updated(x[44:], y[44:])
        assert len(tp.inputs) == 60
        want = jpr(xq, mean=True, std=True, var=True)
        assert_close(dict(tpr(xq, mean=True, std=True, var=True)),
                     {k: np.asarray(v) for k, v in want.items()}, "float64")
        fresh = g3t.SGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), inducing=z,
                        name="SPu")
        fresh.observed(x, y)
        got = fresh.predictor(params)(xq, mean=True, std=True)
        np.testing.assert_allclose(tpr(xq)["mean"], got["mean"], rtol=1e-9)
        np.testing.assert_allclose(tpr(xq)["std"], got["std"], rtol=1e-9)
        # pathwise draws of the sparse state
        S, F = 5, 64
        key = random.PRNGKey(3)
        k_prior, k_eps = random.split(key)
        parts = [jax_draws(random.fold_in(k_prior, 0), 2, F, n_paths=S)]
        for noise in (False, True):
            want = jpr.pathwise_sampler(space=xq, samples=S, key=3, n_features=F, noise=noise)
            draws = {"parts": parts,
                     "xi": np.asarray(random.normal(k_eps, (6, S), dtype=jnp.float64))}
            if noise:
                draws["noise"] = np.asarray(random.normal(random.fold_in(key, 104729),
                                                          (len(xq), S), dtype=jnp.float64))
            got = tpr.pathwise_sampler(space=xq, samples=S, key=draws, n_features=F,
                                       noise=noise)
            assert got.shape == (len(xq), S)
            assert_close(got, want, "float64", err_msg=f"pathwise noise={noise}")
    # the port's own draws: one seed is one path across query batches
    d1 = tpr.pathwise_sampler(space=xq[:5], samples=3, key=7)
    d2 = tpr.pathwise_sampler(space=xq[2:], samples=3, key=7)
    np.testing.assert_allclose(d1[2:].numpy(), d2[:3].numpy(), rtol=1e-10)


def _fit_data():
    rng = np.random.default_rng(2)
    n = 40
    x = np.sort(rng.uniform(0.0, 6.0, n)).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y, np.linspace(0.3, 5.7, 5).reshape(-1, 1)


def _jax_indices(key, steps, bs, n):
    keys = random.split(random.PRNGKey(key), steps)
    return np.stack([np.asarray(random.randint(k, (bs,), 0, n)) for k in keys])


@pytest.mark.parametrize("natgrad", [None, 0.5])
def test_fit_svgp_matches_jax(natgrad):
    """Adam (optax's update, written out) or the natural-gradient steps:
    the full batch deterministic, the minibatches the JAX package's
    ``jax.random.randint`` draws injected; loss trajectories at 1e-8 and
    the trained hypers at 1e-7."""
    x, y, z = _fit_data()
    steps, bs = 15, 12
    with floatx("float64"):
        jp, tp = process_pair(_build("sgp", x, z, "SPf"), x, y)
        for batch, key in ((100, 0), (bs, _jax_indices(3, steps, bs, len(x)))):
            pj, lj = jp.fit_svgp(batch_size=batch, steps=steps, lr=0.02, natgrad=natgrad,
                                 key=3, display=False)
            pt, lt = tp.fit_svgp(batch_size=batch, steps=steps, lr=0.02, natgrad=natgrad,
                                 key=key, display=False)
            np.testing.assert_allclose(lt, np.asarray(lj), rtol=1e-8, err_msg=str(batch))
            # Adam divides by sqrt(v) + 1e-8: a gradient that is 0 but for
            # rounding (the Bias here, ~1e-15) moves its hyper by rounding
            # times 1e8 a step, so the hypers are held at 1e-7 absolute
            for k in pj:
                np.testing.assert_allclose(pt[k], np.asarray(pj[k]), rtol=1e-7, atol=1e-7,
                                           err_msg=k)
    with pytest.raises(NotImplementedError, match="item 16"):
        tp.fit_svgp(steps=2, mesh=2)
    with pytest.raises(ValueError, match="natgrad"):
        tp.fit_svgp(steps=2, natgrad=1.5)


def test_natgrad_one_full_step_is_the_collapsed_optimum():
    """rho = 1 at |B| = n: one step puts q at the collapsed optimum, so the
    first loss equals minus the collapsed bound plus the prior terms."""
    x, y, z = _fit_data()
    with floatx("float64"):
        tp = _build("sgp", x, z, "SPo")(g3t)
        tp.observed(x, y)
        p0 = tp.params_default
        _, losses = tp.fit_svgp(batch_size=100, steps=1, lr=1e-12, natgrad=1.0,
                                display=False)
        np.testing.assert_allclose(-losses[0], tp.logp(p0), rtol=1e-9)


def test_select_inducing_both_branches(monkeypatch):
    """The port's own k-means gives the JAX package's k-means centers
    (scikit-learn's KMeans, 4 inits): exactly where the rows are one of
    scikit-learn's chunks (256), within 1e-10 over several; fewer points
    than slots tile with a jitter.  With scikit-learn hidden the port takes
    the same path (the card has no scikit-learn), where the JAX package
    falls back to a seeded subset."""
    from sklearn.cluster import KMeans

    from g3py_tpu.models.sparse import select_inducing as j_sel

    x = np.random.default_rng(4).standard_normal((80, 2))
    for name in ("float64", "float32"):
        with floatx(name):
            np.testing.assert_array_equal(g3t.select_inducing(x, 7), j_sel(x, 7))
            np.testing.assert_array_equal(g3t.select_inducing(x[:5], 7), j_sel(x[:5], 7))
    wide = np.random.default_rng(5).standard_normal((1000, 8))
    with floatx("float64"):
        np.testing.assert_allclose(
            g3t.select_inducing(wide, 64, seed=3),
            KMeans(n_clusters=64, n_init=4, random_state=3).fit(wide).cluster_centers_,
            rtol=1e-10, atol=1e-10)
    want = g3t.select_inducing(x, 7, seed=2)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    np.testing.assert_array_equal(g3t.select_inducing(x, 7, seed=2), want)
    subset = j_sel(x, 7, seed=2)
    rows = np.asarray(x, np.float32)
    assert all(any(np.array_equal(r, q) for q in rows) for r in subset)


def _algebra(lib, x):
    """The kernels of the diagonal test, each with its count of square block
    grams (blocks of 16 over 40 points): K1 leaves under a sum, a product,
    a maximum, a scale and a shift take none; a LIN leaf takes 3."""
    return (("se", lambda: lib.SE(x), 0),
            ("sum", lambda: lib.SE(x) + lib.MAT32(x), 0),
            ("prod", lambda: lib.SE(x) * lib.MAT52(x), 0),
            ("max", lambda: lib.KernelMax(lib.SE(x), lib.MAT32(x)), 0),
            ("scale_shift", lambda: 0.5 + 2.0 * (lib.SE(x) * lib.MAT32(x)), 0),
            ("lin", lambda: lib.SE(x) + lib.LIN(x), 3))


def test_signal_kernel_diag_routes(monkeypatch):
    """The diagonal follows the kernel algebra to its leaves: a K1 leaf
    gives its amplitude, with no launch; any other leaf the diagonals of
    square block grams; all equal the JAX package's 1 x 1 grams, for one
    params dict and for rows."""
    x, _, _ = _data(n=40)
    spy = KernelSpy(monkeypatch)
    blocks = [0]
    lin_cov = g3t.LIN.cov

    def spy_lin(self, *a, **kw):
        blocks[0] += 1
        return lin_cov(self, *a, **kw)

    monkeypatch.setattr(g3t.LIN, "cov", spy_lin)
    with floatx("float64"):
        for (label, jbuild, calls), (_, tbuild, _) in zip(_algebra(g3, x), _algebra(g3t, x)):
            jk, tk = jbuild(), tbuild()
            jk.check_hypers("D_")
            tk.check_hypers("D_")
            params = nudged({h.name: np.asarray(v) for h, v in
                             jk.default_hypers_dims(x, np.sin(x[:, 0])).items()})
            want = jax.jit(lambda p, xx: j_diag(jk, p, xx))(
                {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
            blocks[0] = 0
            got = t_diag(tk, {k: torch.as_tensor(v) for k, v in params.items()},
                         torch.as_tensor(x), block=16)
            assert spy.take()[0] == 0 and blocks[0] == calls, label
            assert_close(got, want, "float64")
            rows = {k: torch.as_tensor(np.stack([v, 1.1 * v])) for k, v in params.items()}
            got_r = t_diag(tk, rows, torch.as_tensor(x), block=16)
            assert got_r.shape == (2, len(x)), label
            np.testing.assert_allclose(got_r[0].numpy(), got.numpy(), rtol=1e-12)
            spy.take()


def test_sample_hypers_and_refusals():
    """The ensemble sampler over an SGP (batched rows of the bound), and the
    JAX package's refusals."""
    x, y, _ = _data(n=30)
    with floatx("float64"):
        tp = _build("sgp", x, _z(x, 4), "SPs")(g3t)
        tp.observed(x, y)
        chain, lnprob = tp.sample_hypers(start=tp.params_default, samples=4, chains=24,
                                         raw=True, seed=1)
        assert chain.shape == (24, 4, tp.active.ndim) and np.isfinite(lnprob).all()
    with pytest.raises(ValueError, match="noisy=True"):
        g3t.SGP(space=x, kernel=g3t.SE(x), noisy=False, inducing=4, name="SPn")
    with pytest.raises(ValueError, match="KernelNoise"):
        g3t.SGP(space=x, kernel=g3t.SE(x) + g3t.KernelNoise(), inducing=4, name="SPk")
    fixed = g3t.SGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), inducing=5,
                    learn_inducing=False, name="SPx")
    with pytest.raises(ValueError, match="observed"):
        fixed.f_inducing.value({})
    fixed.observed(x, y)
    assert not any("Inducing" in k for k in fixed.params_default)
    assert np.isfinite(fixed.loglike(fixed.params_default))
