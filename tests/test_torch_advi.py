"""Port parity of ADVI (g3py_tpu_torch/bayesian/advi.py) against the JAX
package's at float64: ``_unpack`` (full rank and mean field) to 1e-12,
then 50 steps of ``fit_advi`` on a GP(Bias, SE) posterior with n=16 — the
JAX package's normals of every step (its key splits) fed to the port's
``_elbo_draws`` — comparing the averaged mean, the scale and the ELBO trace
to 1e-8, with one batched value-and-gradient evaluation of the ``mc`` rows
a step; and ``advi_draws`` from the same normals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from g3py_tpu.bayesian import advi as jadvi
from g3py_tpu_torch.bayesian import advi as tadvi
from g3py_tpu_torch.bayesian import samplers as tsam

from torch_parity import KernelSpy, floatx, process_pair


def test_unpack_matches_jax():
    with floatx("float64"):
        theta = np.random.default_rng(0).standard_normal(3 + 3 + 9)
        for full_rank, size in ((True, 15), (False, 6)):
            want = jadvi._unpack(jnp.asarray(theta[:size]), 3, full_rank)
            got = tadvi._unpack(torch.as_tensor(theta[:size]), 3, full_rank)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def _gp_pair(n=16):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    return process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                           name="ADVI_GP"), x, y)


@pytest.mark.parametrize("full_rank", [True, False])
def test_fit_advi_matches_jax(monkeypatch, full_rank):
    steps, mc, seed = 50, 4, 3
    with floatx("float64"):
        jp, tp = _gp_pair()
        z0 = tp.active.dict_to_array(tp.params_default)
        want = jadvi.fit_advi(jp._sampling_logps()[0], z0, steps=steps, mc=mc, lr=0.05,
                              full_rank=full_rank, seed=seed)
        eps = [np.array(random.normal(k, (mc, len(z0)), dtype=jnp.float64))
               for k in random.split(random.PRNGKey(seed), steps)]
        monkeypatch.setattr(tadvi, "_elbo_draws",
                            lambda gen, shape, dtype, device: torch.as_tensor(eps.pop(0)))
        spy = KernelSpy(monkeypatch)
        calls0 = tsam.value_and_grad.calls
        got = tadvi.fit_advi(tp._sampling_logps()[0], z0, steps=steps, mc=mc, lr=0.05,
                             full_rank=full_rank, seed=seed)
        assert not eps and tsam.value_and_grad.calls - calls0 == steps
        assert spy.take() == (steps, steps)  # one batched K1 and K2 call a step
    for key in ("mu", "scale_tril", "elbo"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-8, atol=1e-8,
                                   err_msg=key)
    assert got.converged == want.converged
    assert not np.allclose(got.mu, z0)


def test_advi_draws_match_jax(monkeypatch):
    with floatx("float64"):
        fit = {"mu": np.array([0.5, -1.0]), "scale_tril": np.array([[0.3, 0.0], [0.2, 0.1]])}
        fit = type("Fit", (), fit)
        want = jadvi.advi_draws(fit, 3, 5, seed=4)
        eps = np.array(random.normal(random.PRNGKey(4), (3, 5, 2), dtype=jnp.float64))
        monkeypatch.setattr(tadvi, "_draws",
                            lambda gen, shape, dtype, device: torch.as_tensor(eps))
        got = tadvi.advi_draws(fit, 3, 5, seed=4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-12)
