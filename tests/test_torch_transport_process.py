"""Port parity of the transport process (TGP) with the JAX package: logp
and dlogp, the sampler and the Monte-Carlo moments from the same numpy
draws, ``predict`` drawing once for every moment, the TKernel identity
with the zero-mean GP, and ``find_MAP`` (the ``tgp_logp_default`` pin is
tests/test_torch_parity.py's).

Tolerances: float64 against JAX x64 at rtol/atol 1e-10, float32 at rtol
1e-4 / atol 1e-5 (``torch_parity``); ``find_MAP``'s optimum (float64) at
1e-6 relative in logp."""

import numpy as np
import torch
import pytest

import g3py_tpu_torch as g3t

from test_torch_transport import NAMES, _data, _tgp_pair
from torch_parity import assert_close, floatx, to_numpy


@pytest.mark.parametrize("name", NAMES)
def test_tgp_logp_dlogp_and_moments(name):
    """TGP logp/dlogp; the sampler from the same numpy Generator; the
    Monte-Carlo moments of ``predict`` over the same draws."""
    with floatx(name):
        x, y = _data()
        jp, tp = _tgp_pair("TComposed", "TGPM", x, y)
        params = {k: np.asarray(v) for k, v in jp.params_default.items()}
        u = jp.active.dict_to_array(params)
        assert_close(tp.logp(params), np.asarray(jp.logp(params)), name)
        assert_close(tp.dlogp(u), np.asarray(jp.dlogp(u)), name)
        xq = np.linspace(-0.5, 6.5, 6).astype(np.float32).reshape(-1, 1)
        for prior in (False, True):
            want = jp.sampler(params, space=xq, samples=8, prior=prior,
                              rng=np.random.default_rng(3))
            got = tp.sampler(params, space=xq, samples=8, prior=prior,
                             rng=np.random.default_rng(3))
            assert got.shape == (6, 8)
            assert_close(got, np.asarray(want), name)
        flags = dict(quantiles=True, var=True, median=True)
        want = jp.predict(params, space=xq, simulations=np.asarray(want), **flags)
        got = tp.predict(params, space=xq, simulations=got, **flags)
        assert_close(got, {k: np.asarray(v) for k, v in want.items()}, name)


def test_predict_draws_once():
    """``predict(simulations=S, rng=...)`` draws once for every moment (the
    same as the sampler's draws from the same seed)."""
    x, y = _data()
    _, tp = _tgp_pair("TComposed", "TGPD", x, y)
    xq = np.linspace(0.0, 6.0, 5).astype(np.float32).reshape(-1, 1)
    draws = tp.sampler(space=xq, samples=30, rng=np.random.default_rng(9))
    out = tp.predict(space=xq, quantiles=True, median=True, simulations=30,
                     rng=np.random.default_rng(9))
    np.testing.assert_array_equal(out["mean"], torch.as_tensor(draws).mean(dim=1).numpy())
    np.testing.assert_allclose(out["quantile_up"],
                               np.percentile(draws, 97.5, axis=1), rtol=1e-6)
    assert np.all(out["quantile_down"] <= out["quantile_up"])


def test_tkernel_is_the_zero_mean_gp():
    """A pure TKernel transport is the zero-mean GP's likelihood at aligned
    params (the JAX package's identity, tests/test_models.py)."""
    with floatx("float64"):
        x, y = _data()
        tgp = g3t.TGP(space=x, transport=g3t.TKernel(g3t.SE(x), noisy=True), name="TGPI")
        tgp.observed(x, y)
        gp = g3t.GP(space=x, location=g3t.Zero(), kernel=g3t.SE(x), name="GPI")
        gp.observed(x, y)
        pt = tgp.params_default
        pg = {"GPI_SE_var": pt["TGPI_SE_var"], "GPI_SE_rate": pt["TGPI_SE_rate"],
              "GPI_Noise_var": pt["TGPI_NoiseSE_var"]}
        np.testing.assert_allclose(tgp.loglike(pt), gp.loglike(pg), rtol=1e-12)


def test_find_map_reaches_jax_optimum():
    with floatx("float64"):
        x, y = _data(n=16)
        jp, tp = _tgp_pair("TComposed", "TGPF", x, y)
        jmap = jp.find_MAP(points=1, powell=False, display=False)
        tmap = tp.find_MAP(points=1, powell=False, display=False)
        lj, lt = float(jp.logp(jmap)), tp.logp(tmap)
        assert lt > tp.logp(tp.params_default) + 1.0
        np.testing.assert_allclose(lt, lj, rtol=1e-6)
        np.testing.assert_allclose(tp.logp(jmap), lj, rtol=1e-10)
        # rows evaluate one at a time (no row axis in this family)
        rows = np.stack([jp.active.dict_to_array(jmap), jp.active.dict_to_array(tmap)])
        assert_close(tp.logp_chain(rows), np.asarray(jp.logp_chain(rows)), "float64")
        assert to_numpy(tp.transport(tmap, vector=y)).shape == (len(y),)
