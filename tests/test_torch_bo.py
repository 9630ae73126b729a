"""Port parity of ``BayesOpt`` against the JAX package's (float64 at 1e-10
unless stated): every acquisition and its gradient in the candidates —
logEI's far-left tail (z < -4) included, on a GP and on a warped GP whose
moments go through the mapping's quadrature — with the port's state
factored once per conditioning set against the JAX package's refactor
inside every call; the three liars' fantasies; Thompson picks from
the JAX package's injected draws.  ``suggest`` and ``run`` are held in
tests/test_torch_bo_run.py."""

import numpy as np
import pytest
import torch
from jax import random

import jax
import jax.numpy as jnp

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from test_torch_rff import jax_draws
from torch_parity import floatx, jax_eager


def _data(n=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 4.0, (n, 1))
    y = np.sin(3 * x[:, 0]) + 0.7 * np.cos(5 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    return x, y


MODELS = {
    "gp": lambda lib, x: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x), noisy=True,
                                name="BO_GP"),
    "wgp": lambda lib, x: lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x), noisy=True,
                                  mapping=lib.BoxCoxShifted(), name="BO_WGP"),
}


def _pair(model, xi=0.05, seed=1):
    x, y = _data()
    if model == "wgp":
        y = y + 3.0
    out = []
    for lib in (g3, g3t):
        proc = MODELS[model](lib, x)
        bo = lib.BayesOpt(proc, bounds=[[0.0, 4.0]], maximize=True, seed=seed, xi=xi)
        bo.tell(x, y)
        out.append(bo)
    jb, tb = out
    params = {k: np.asarray(v) * 1.1 for k, v in jb.process.params_default.items()}
    return jb, tb, params


# the query points: near the data, and far out in the left tail of logEI
X = np.array([[0.05], [0.7], [1.3], [2.2], [3.1], [3.95]])


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kind", ["logEI", "logEI_tail", "EI", "PI", "UCB"])
def test_acquisition_and_gradient_match_jax(model, kind):
    tail = kind == "logEI_tail"
    kind = "logEI" if tail else kind
    with floatx("float64"), jax_eager():
        # xi = 3 puts every z below -4: logEI's asymptotic branch
        jb, tb, params = _pair(model, xi=3.0 if tail else 0.05)
        pj = {k: jnp.asarray(v) for k, v in params.items()}
        inputs, outputs, best_g = jb._data_jnp()
        acq = jb._acq_pure(kind)
        want, want_g = jax.value_and_grad(
            lambda xx: acq(pj, xx, inputs, outputs, best_g).sum())(jnp.asarray(X))
        want_v = np.asarray(acq(pj, jnp.asarray(X), inputs, outputs, best_g))
        t_in, t_out, t_best = tb._data()
        p = tb._conditioned(params, t_in, t_out)
        xt = torch.as_tensor(X).requires_grad_(True)
        got = tb._acq(kind, p, xt, t_in, t_out, t_best)
        (got_g,) = torch.autograd.grad(got.sum(), xt)
        if kind == "logEI":
            mean, sd = tb._moments(p, xt, t_in, t_out)
            z = (tb._sign * mean - t_best - tb.xi) / sd
            assert bool((z < -4).all()) if tail else bool((z > -4).any())
        host = tb.acquisition(X, params, kind=kind)
    np.testing.assert_allclose(got.detach().numpy(), want_v, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(host, want_v, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("liar", ["mean", "best", "worst"])
def test_fantasy_liars_match_jax(liar):
    with floatx("float64"), jax_eager():
        jb, tb, params = _pair("gp")
        pj = {k: jnp.asarray(v) for k, v in params.items()}
        inputs, outputs, _ = jb._data_jnp()
        want = float(jb._fantasy(pj, np.array([1.7]), inputs, outputs, liar))
        t_in, t_out, _ = tb._data()
        got = float(tb._fantasy(tb._conditioned(params, t_in, t_out), np.array([1.7]), t_in,
                                t_out, liar))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_thompson_from_injected_draws():
    q, n_features = 3, 2048
    with floatx("float64"):
        jb, tb, params = _pair("gp")
        want = jb.suggest(params, kind="thompson", q=q, candidates=64, key=4)
        key = random.PRNGKey(4)
        k_prior, k_eps = random.split(key)
        n = len(jb.process.inputs)
        draws = {"parts": [jax_draws(random.fold_in(k_prior, 0), 1, n_features, n_paths=q)],
                 "eps": np.asarray(random.normal(k_eps, (n, q), dtype=jnp.float64))}
        got = tb.suggest(g3t.params_from_jax(tb.process, params), kind="thompson", q=q,
                         candidates=64, key=draws)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
