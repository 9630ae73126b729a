"""Port parity of the matrix-free model surface against the JAX package:
``nll_iterative`` (value and gradient through the flat vector, a warped GP's
Jacobian included, and its two refusals), ``find_MAP(engine='iterative')``
with ``loop='host'`` and ``loop='device'`` (held to the JAX package's
optimum, not its iterates), the untrusted-start handling, and the
``IterativePredictor`` (statistics with ``exact_var`` both ways, warped
moments, ``dtype='float64'``, the pathwise ``sampler`` from the JAX
package's draws, the refusals).  The JAX package's probes and draws are
rebuilt from its keys and injected; float64 against JAX x64 at 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import g3py_tpu_torch as g3t

from test_torch_pathwise import F, S, _injected
from torch_parity import assert_close, floatx, nudged, process_pair


def _probes(seed, probes, n):
    """The JAX package's SLQ and gradient probes of ``seed`` (the
    ``preconditioned_gp_nll`` streams)."""
    slq = random.rademacher(random.PRNGKey(seed), (probes, n), dtype=jnp.float64)
    grad = 2.0 * random.bernoulli(random.PRNGKey(seed + 104729), 0.5, (probes, n)) - 1.0
    return {"slq": np.asarray(slq), "grad": np.asarray(grad, np.float64)}


def _data(n, seed=0, warped=False):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 15, n)).reshape(-1, 1)
    y = np.sin(0.6 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    if warped:
        y = np.exp(0.3 * y) + 1.0
    return x, y


NLL_KW = dict(rank=30, cg_iters=300, probes=16, lanczos_iters=30, block=64)


def test_nll_iterative_value_and_gradient():
    """A warped GP through ``array_to_dict`` of the flat vector, blocks of
    64 (ragged at n=96): the value includes the warping's Jacobian, as
    ``loglike``; the gradient reaches the kernel, noise, mean and warping
    hypers (through the stochastic-trace backward and y = T^{-1}(outputs))."""
    n = 96
    x, y = _data(n, 1, warped=True)

    def build(lib):
        return lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                       mapping=lib.BoxCoxLinear(y), name="ITW")

    with floatx("float64"):
        jp, tp = process_pair(build, x, y)
        params = nudged(jp.params_default)
        reg = jp.active
        u0 = np.asarray(reg.dict_to_array(params))
        (want, info_w), gw = jax.value_and_grad(
            lambda u: jp.nll_iterative(reg.array_to_dict_jax(u), **NLL_KW), has_aux=True)(
            jnp.asarray(u0))
        ut = torch.tensor(u0, requires_grad=True)
        got, info = tp.nll_iterative(tp.active.array_to_dict_tensor(ut),
                                     seed=_probes(0, 16, n), **NLL_KW)
        got.backward()
        got = got.detach()
        assert_close(got, want, "float64")
        assert_close(ut.grad, gw, "float64")
        assert_close({k: v.detach() for k, v in info.items()}, dict(info_w), "float64")
        np.testing.assert_allclose(float(got), -tp.loglike(params), rtol=2e-2)


def test_nll_iterative_refusals():
    x, y = _data(16)
    with floatx("float64"):
        gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), noisy=False, name="ITR1")
        gp.observed(x, y)
        with pytest.raises(ValueError, match="noisy=True"):
            gp.nll_iterative()
        gp2 = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x) + g3t.KernelNoise(x),
                     name="ITR2")
        gp2.observed(x, y)
        with pytest.raises(ValueError, match="KernelNoise"):
            gp2.nll_iterative()
        with pytest.raises(ValueError, match="KernelNoise"):
            gp2.predictor_iterative()
        with pytest.raises(ValueError, match="objective='loo'"):
            gp2.find_MAP(engine="iterative", objective="loo", display=False)
        # the band-sharded engine refuses it as nll_iterative does
        with pytest.raises(ValueError, match="KernelNoise"):
            gp2.find_MAP(engine="distributed", display=False)


MAP_KW = dict(rank=24, cg_iters=200, probes=16, lanczos_iters=25, block=32)


@pytest.fixture(scope="module")
def map_case():
    """GP(Bias, SE) on 64 points and the JAX package's iterative MAP (host
    loop, float64, its own probes), computed once."""
    n = 64
    x, y = _data(n, 2)
    with floatx("float64"):
        jp, tp = process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(),
                                                 kernel=lib.SE(x), name="ITMAP"), x, y)
        jmap = jp.find_MAP(points=1, engine="iterative", display=False, max_iters=60,
                           **MAP_KW)
    return jp, tp, jmap, n


@pytest.mark.parametrize("loop", ["host", "device"])
def test_find_map_iterative_reaches_the_jax_optimum(map_case, loop):
    """The port's host loop (scipy on the same objective, the JAX
    package's probes) lands where the JAX package's does; the device loop
    (the port's guarded L-BFGS) reaches the same optimum."""
    jp, tp, jmap, n = map_case
    with floatx("float64"):
        got = tp.find_MAP(points=1, engine="iterative", loop=loop, display=False,
                          max_iters=60, seed=_probes(0, MAP_KW["probes"], n), **MAP_KW)
        want = jp.logp(jmap)
        start = jp.logp(jp.params_default)
        assert jp.logp(got) > start + 1.0
        tol = 1e-6 * abs(want) if loop == "host" else 0.05
        assert jp.logp(got) >= want - tol, (jp.logp(got), want)
        if loop == "host":
            assert_close({k: np.asarray(v) for k, v in got.items()},
                         {k: np.asarray(v) for k, v in jmap.items()}, "float32")


def test_find_map_iterative_untrusted_starts(map_case, capsys):
    """A start whose CG solve is untrusted (residual > 5e-2) is skipped with
    the JAX package's message; when every start is, a ValueError."""
    jp, tp, _, n = map_case
    with floatx("float64"):
        bad = dict(rank=1, cg_iters=1, probes=4, lanczos_iters=5, block=32)
        for loop, what in (("host", "untrusted at the start point"),
                           ("device", "never reached a trusted region")):
            with pytest.raises(ValueError, match="every start point was"):
                tp.find_MAP(points=1, engine="iterative", loop=loop, display=False,
                            max_iters=3, **bad)
            assert what in capsys.readouterr().out
        with pytest.raises(ValueError, match="unknown loop"):
            tp.find_MAP(engine="iterative", loop="gpu", display=False, **MAP_KW)


PRED_KW = dict(rank=32, cg_iters=300, block=64)


@pytest.fixture(scope="module")
def predictors():
    """GP and WGP(LogShifted) on 96 points, float64: the JAX package's
    IterativePredictor and the port's at the same params."""
    out = {}
    with floatx("float64"):
        for name, warped in (("gp", False), ("wgp", True)):
            x, y = _data(96, 3, warped)

            def build(lib, x=x, y=y, warped=warped):
                kw = dict(space=x, location=lib.Bias(), kernel=lib.SE(x), name="ITP" + name)
                if warped:
                    return lib.WGP(mapping=lib.LogShifted(y), **kw)
                return lib.GP(**kw)

            jp, tp = process_pair(build, x, y)
            params = nudged(jp.params_default)
            out[name] = (jp, tp, params, jp.predictor_iterative(params, **PRED_KW),
                         tp.predictor_iterative(params, **PRED_KW))
    return out


@pytest.mark.parametrize("name", ["gp", "wgp"])
@pytest.mark.parametrize("exact_var", [True, False])
def test_iterative_predictor_statistics(predictors, name, exact_var):
    jp, tp, params, jpr, tpr = predictors[name]
    xq = np.linspace(-1, 16, 23).reshape(-1, 1)
    with floatx("float64"):
        assert_close(tpr.alpha, jpr.alpha, "float64")
        assert_close(tpr.l_factor, jpr.l_factor, "float64")
        np.testing.assert_allclose(tpr.cg_rel_residual, jpr.cg_rel_residual, rtol=1e-6)
        want = jpr(xq, var=True, median=True, quantiles=True, quantiles_noise=True,
                   exact_var=exact_var)
        got = tpr(xq, var=True, median=True, quantiles=True, quantiles_noise=True,
                  exact_var=exact_var)
        assert set(got) == set(want)
        # a WGP's std: the JAX package's sqrt(E[T^2] - E[T]^2) cancels to
        # sqrt(eps) |E[T]| (~3e-8 here) where the latent variance is ~0;
        # the port's centred second moment does not (ROADMAP Queue 3)
        moments = ("std", "variance", "noise_std") if name == "wgp" else ()
        assert_close({k: got[k] for k in want if k not in moments},
                     {k: want[k] for k in want if k not in moments}, "float64")
        for k in moments:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-10,
                                       atol=1e-7, err_msg=k)
        yq = np.interp(xq[:, 0], jp.inputs[:, 0], jp.outputs)
        assert_close(tpr.logpredictive(yq, space=xq, exact_var=exact_var),
                     jpr.logpredictive(yq, space=xq, exact_var=exact_var), "float64")
        if exact_var:  # the exact variance is the dense Predictor's
            dense = tp.predictor(params)(xq, quantiles=True)
            for k in ("mean", "std", "quantile_up"):
                np.testing.assert_allclose(got[k], dense[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)


def test_iterative_predictor_sampler_from_jax_draws(predictors, noise=True):
    """The pathwise draws (RFF prior paths, one multi-RHS PCG update, the
    output noise) from the JAX package's key splits, injected."""
    jp, tp, params, jpr, tpr = predictors["gp"]
    xq = np.linspace(0, 15, 9).reshape(-1, 1)
    with floatx("float64"):
        want = jpr.sampler(space=xq, samples=S, key=random.PRNGKey(3), n_features=F,
                           noise=noise)
        draws = _injected(params, None, [(None, None, 1)], 3, 96, len(xq), noise)
        got = tpr.sampler(space=xq, samples=S, key=draws, n_features=F, noise=noise)
        assert got.shape == (len(xq), S)
        assert_close(got, want, "float64")


def test_iterative_predictor_float64_solve():
    """``dtype='float64'`` under float32 settings: the solve in float64,
    the statistics in float32, against the JAX package's float64 solve."""
    x, y = _data(96, 4)
    jp, tp = process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                             name="ITF64"), x, y)
    params = nudged(jp.params_default)
    xq = np.linspace(0, 15, 11).reshape(-1, 1)
    jpr = jp.predictor_iterative(params, dtype="float64", **PRED_KW)
    tpr = tp.predictor_iterative(params, dtype="float64", **PRED_KW)
    assert tpr.alpha.dtype == torch.float64
    want, got = jpr(xq, var=True), tpr(xq, var=True)
    assert all(v.dtype == np.float32 for v in got.values())
    assert_close({k: got[k] for k in want}, dict(want), "float32")


def test_iterative_predictor_refusals():
    x, y = _data(48, 5)
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="ITREF")
    gp.observed(x, y)
    tp = g3t.TP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="ITREFT")
    tp.observed(x, y)
    with pytest.raises(ValueError, match="gaussian"):
        g3t.IterativePredictor(tp, tp.params_default)
    with pytest.raises(ValueError, match="did not converge"):
        gp.predictor_iterative(gp.params_default, rank=1, cg_iters=1)
    pr = gp.predictor_iterative(gp.params_default, rank=16)
    gp.observed(x[:24], y[:24])
    with pytest.raises(ValueError, match="rebuild"):
        pr.mean(x[:8])
