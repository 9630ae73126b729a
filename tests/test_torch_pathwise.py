"""Port parity of ``Predictor.pathwise_sampler`` (Matheron's update with
random-Fourier prior paths) against the JAX package's, fed the JAX
package's draws (rebuilt from its key splits: one ``fold_in`` per feature
block, the observation noise, the output noise): SE, MAT52, RQ, a sum and
dims-restricted parts.  Then the port's own draws: one seed gives one
consistent path across query batches, the moments match the posterior,
and the refusals (Student-t, a kernel without a spectral density, a
product) are the JAX package's."""

import numpy as np
import pytest
import torch
from jax import random

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from test_torch_rff import jax_draws
from torch_parity import assert_close, floatx, nudged, process_pair

S, F = 5, 64


def _data(n=30, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 6.0, (n, 2))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1] + 0.1 * rng.standard_normal(n)
    xq = rng.uniform(-0.5, 6.5, (7, 2))
    return x, y, xq


KERNELS = {
    "se": (lambda lib, x: lib.SE(x), [(None, None, 2)]),
    "mat52": (lambda lib, x: lib.MAT52(x), [(2.5, None, 2)]),
    "rq": (lambda lib, x: lib.RQ(x), [(None, "alpha", 2)]),
    "sum": (lambda lib, x: lib.SE(x) + lib.MAT32(x), [(None, None, 2), (1.5, None, 2)]),
    "dims": (lambda lib, x: lib.SE([0]) + lib.MAT52([1]), [(None, None, 1), (2.5, None, 1)]),
}


def _injected(params, alpha_name, parts, key, n, m, noise):
    """The JAX package's draws for ``pathwise_sampler(key=key)``."""
    key = random.PRNGKey(key)
    k_prior, k_eps = random.split(key)
    f_each = max(F // len(parts), 64)
    blocks = []
    for i, (nu, alpha, ndim) in enumerate(parts):
        rq_alpha = float(np.asarray(params[alpha_name])) if alpha else None
        blocks.append(jax_draws(random.fold_in(k_prior, i), ndim, f_each, n_paths=S, nu=nu,
                                rq_alpha=rq_alpha))
    from g3py_tpu.config import settings as jset
    out = {"parts": blocks, "eps": np.asarray(random.normal(k_eps, (n, S), dtype=jset.dtype))}
    if noise:
        out["noise"] = np.asarray(random.normal(random.fold_in(key, 104729), (m, S),
                                                dtype=jset.dtype))
    return out


@pytest.mark.parametrize("case", sorted(KERNELS))
def test_pathwise_matches_jax_from_its_draws(case):
    kernel, parts = KERNELS[case]
    x, y, xq = _data()
    with floatx("float64"):
        jp, tp = process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(),
                                                 kernel=kernel(lib, x), name="PW" + case), x, y)
        params = nudged(jp.params_default)
        alpha = next((k for k in params if k.endswith("_alpha")), None)
        jpr, tpr = jp.predictor(params), tp.predictor(g3t.params_from_jax(tp, params))
        for noise in (False, True):
            want = jpr.pathwise_sampler(space=xq, samples=S, key=3, n_features=F, noise=noise)
            draws = _injected(params, alpha, parts, 3, len(x), len(xq), noise)
            got = tpr.pathwise_sampler(space=xq, samples=S, key=draws, n_features=F,
                                       noise=noise)
            assert got.shape == (len(xq), S)
            assert_close(got, want, "float64", err_msg=f"{case} noise={noise}")


def test_one_seed_is_one_path_and_moments():
    """Draws from one seed over overlapping query batches agree at the
    shared points; over 600 paths the mean is within 5 standard errors of
    the posterior mean and the std ratio inside (0.8, 1.2) (the JAX
    package's bounds)."""
    x, y, _ = _data(n=40, seed=2)
    xq = np.linspace(0.0, 6.0, 24).reshape(-1, 2)
    with floatx("float64"):
        tp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="PWM")
        tp.observed(x, y)
        pr = tp.predictor(nudged({k: np.asarray(v) for k, v in tp.params_default.items()}))
        full = pr.pathwise_sampler(space=xq, samples=4, key=7, n_features=256)
        part = pr.pathwise_sampler(space=xq[3:9], samples=4, key=7, n_features=256)
        torch.testing.assert_close(part, full[3:9], rtol=1e-12, atol=1e-12)
        draws = pr.pathwise_sampler(space=xq, samples=600, key=1, n_features=4096).numpy()
        ref = pr(xq)
        mu, sd = ref["mean"], ref["std"]
        assert np.max(np.abs(draws.mean(1) - mu) / (sd / np.sqrt(600))) < 5
        ratio = draws.std(1) / sd
        assert np.all(ratio > 0.8) and np.all(ratio < 1.2), ratio


def test_refusals_match_jax():
    x, y, xq = _data(n=12)
    with floatx("float32"):
        for kernel, kind, match in (
                (lambda lib: lib.OU(x), "GP", "sums of them"),
                (lambda lib: lib.SE(x) * lib.COS(x), "GP", "sums of them"),
                (lambda lib: lib.SE(x), "TP", "Student-t")):
            for lib in (g3, g3t):
                proc = getattr(lib, kind)(space=x, location=lib.Bias(), kernel=kernel(lib),
                                          name="PWR" + kind)
                proc.observed(x, y)
                with pytest.raises(ValueError, match=match):
                    proc.predictor().pathwise_sampler(space=xq, samples=2)
