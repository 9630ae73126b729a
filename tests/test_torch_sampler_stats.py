"""The statistical assertions of tests/test_samplers.py's ``TestNUTS``,
``TestNeuTra`` and ``TestADVI`` rerun on the port, in float32 on the CPU:
the samplers recover known target moments, a dense mass cuts the tree
depth on a correlated target, the fitted flow inverts exactly and a
whitening-only flow is the dense metric, NeuTra explores the funnel's neck
that plain NUTS misses, and ADVI recovers a correlated gaussian (mean
field shrinking its variances).  The port's NUTS runs a host loop a leaf,
so the NUTS chains here are shorter than the JAX tests' (the iteration
counts are in each test); the tolerances are the JAX tests'.
"""

import numpy as np
import torch

from g3py_tpu_torch.bayesian.advi import advi_draws, fit_advi
from g3py_tpu_torch.bayesian.neutra import fit_flow, flow_forward, flow_inverse, neutra_nuts
from g3py_tpu_torch.bayesian.nuts import nuts_sampler

import torch_parity  # noqa: F401  (puts the port on the CPU)


def gauss_logp(cov, mu=None):
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)
    mu = torch.zeros(len(cov)) if mu is None else torch.as_tensor(mu, dtype=torch.float32)

    def logp(p):
        d = p - mu
        return -0.5 * ((d @ prec) * d).sum(-1)

    return logp


def test_nuts_recovers_correlated_gaussian():
    cov = np.array([[1.0, 0.8], [0.8, 2.0]], np.float32)
    chain, lnprob, info = nuts_sampler(gauss_logp(cov), np.zeros(2, np.float32), samples=300,
                                       warmup=100, key=0, chains=2)
    np.testing.assert_allclose(np.cov(chain[:, 50:, :].reshape(-1, 2).T), cov, atol=0.4)
    assert np.all(info["divergences"] == 0)
    assert np.all(info["accept_rate"] > 0.5)
    assert np.all(np.isfinite(lnprob))


def test_nuts_dense_mass_cuts_tree_depth():
    cov = np.array([[1.0, 0.95, 0.0], [0.95, 1.0, 0.0], [0.0, 0.0, 0.01]], np.float32)
    depths = {}
    for mass in (True, "dense"):
        chain, _, info = nuts_sampler(gauss_logp(cov), np.zeros(3, np.float32), samples=200,
                                      warmup=100, key=0, chains=2, adapt_mass=mass, chunk=64)
        got = np.cov(chain[:, 50:, :].reshape(-1, 3).T)
        np.testing.assert_allclose(got, cov, atol=0.35, err_msg=str(mass))
        assert np.all(info["divergences"] == 0)
        assert np.all(info["accept_rate"] > 0.5)
        depths[mass] = float(info["mean_tree_depth"].mean())
    assert depths["dense"] < depths[True] - 0.5, depths


def _funnel_draws(m, d, seed=0):
    """Exact draws from Neal's funnel: v ~ N(0, 3^2), x_i | v ~ N(0, e^v)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 3.0, size=(m,)).astype(np.float32)
    x = (rng.standard_normal((m, d - 1)) * np.exp(v / 2)[:, None]).astype(np.float32)
    return np.concatenate([v[:, None], x], axis=1)


def _funnel_logp(d):
    def logp(p):
        v, x = p[:, 0], p[:, 1:]
        return -0.5 * (v / 3.0) ** 2 - 0.5 * (x * x).sum(-1) * torch.exp(-v) - 0.5 * (d - 1) * v

    return logp


def test_flow_round_trip():
    flow, losses = fit_flow(_funnel_draws(512, 3, seed=1), steps=50, key=0)
    theta = torch.as_tensor(np.random.default_rng(2).standard_normal((7, 3)) * 2,
                            dtype=torch.float32)
    z, ld_inv = flow_inverse(flow, theta)
    theta2, ld_fwd = flow_forward(flow, z)
    np.testing.assert_allclose(theta2.numpy(), theta.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ld_fwd.numpy(), -ld_inv.numpy(), rtol=1e-4, atol=1e-4)
    assert losses[-1] < losses[0]


def test_whitening_only_flow_is_dense_metric():
    rng = np.random.default_rng(3)
    cov = np.array([[2.0, 1.2], [1.2, 1.5]], np.float32)
    draws = rng.multivariate_normal([1.0, -2.0], cov, size=4000).astype(np.float32)
    flow, losses = fit_flow(draws, n_couplings=0)
    assert len(losses) == 0
    z = flow_inverse(flow, torch.as_tensor(draws))[0].numpy()
    np.testing.assert_allclose(z.mean(0), 0.0, atol=0.05)
    np.testing.assert_allclose(np.cov(z.T), np.eye(2), atol=0.08)


def test_neutra_beats_nuts_on_funnel():
    d = 2
    logp = _funnel_logp(d)
    draws = _funnel_draws(1024, d, seed=4)
    _, _, info_p = nuts_sampler(logp, np.zeros(d, np.float32), 150, warmup=80, key=0,
                                chains=2, max_depth=5)
    chain_n, lnprob_n, info_n = neutra_nuts(logp, draws, 150, chains=2, warmup=80, key=0,
                                            max_depth=5, fit_steps=400)
    assert chain_n.shape == (2, 150, d)
    assert np.all(np.isfinite(lnprob_n))
    div_p, div_n = int(np.sum(info_p["divergences"])), int(np.sum(info_n["divergences"]))
    assert div_n <= div_p, (div_n, div_p)
    v_n = chain_n[:, :, 0].ravel()
    assert np.std(v_n) > 2.0, np.std(v_n)
    assert abs(np.mean(v_n)) < 1.2, np.mean(v_n)
    assert np.isfinite(info_n["fit_nll"])


def test_advi_recovers_correlated_gaussian():
    cov = np.array([[1.0, 0.8], [0.8, 1.0]], np.float32)
    mu = np.array([1.5, -0.5], np.float32)
    fit = fit_advi(gauss_logp(cov, mu), np.zeros(2, np.float32), steps=1500, mc=16, lr=0.05,
                   seed=1)
    np.testing.assert_allclose(fit.mu, mu, atol=0.08)
    np.testing.assert_allclose(fit.scale_tril @ fit.scale_tril.T, cov, atol=0.15)
    draws = advi_draws(fit, 2, 4000, seed=3)
    assert draws.shape == (2, 4000, 2)
    flat = draws.reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), mu, atol=0.08)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.2)


def test_advi_mean_field_understates_correlation():
    cov = np.array([[1.0, 0.9], [0.9, 1.0]], np.float32)
    fit = fit_advi(gauss_logp(cov), np.zeros(2, np.float32), steps=800, mc=8, lr=0.05,
                   full_rank=False, seed=0)
    assert fit.scale_tril[1, 0] == 0.0
    assert np.all(np.diagonal(fit.scale_tril) ** 2 < 0.5)
