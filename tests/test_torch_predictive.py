"""Port parity of the predictive surface: the full posterior covariance
and its Cholesky, posterior samples from the same standard normals,
``logpredictive``, the prior branch (``prior=True``) of the process and of
the ``Predictor``, ``batch_predict(cov=, median=, prior=)`` and
``average(scores=True)`` / ``AveragedPredictor.predict(scores=True)`` —
each against the JAX package on the same numpy inputs (the models of
tests/test_torch_scores.py)."""

import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from test_torch_scores import _pair
from torch_parity import assert_close, floatx


def test_covariance_cholesky_and_samples_match_jax():
    """GP: the posterior covariance (noise-free and noisy) and the samples
    from the same numpy normals (which compares the robust Cholesky of the
    covariance too); WGP: samples are the warping of the latent draws."""
    with floatx("float64"):
        jp, tp, params, xs, _ = _pair("gp", "COV_GP")
        for noise in (False, True):
            assert_close(dict(tp.predict(params, cov=True, std=False, noise=noise)),
                         dict(jp.predict(params, cov=True, std=False, noise=noise)), "float64")
        assert_close(tp.sampler(params, samples=5, rng=np.random.default_rng(7)),
                     jp.sampler(params, samples=5, rng=np.random.default_rng(7)), "float64")
        chol = tp.cholesky(params, noise=True)
        assert_close(chol @ chol.T, tp.covariance(params, noise=True), "float64")
        assert_close(tp.cholesky_diag(params), np.diag(tp.kernel_sd(params)), "float64")
        s = tp.sample(params, samples=3)
        assert s.shape == (len(xs), 3) and bool(np.isfinite(s).all())
        gen = torch.Generator().manual_seed(0)
        assert tp.sampler(params, samples=4, rng=gen).shape == (len(xs), 4)
        _, tw, wparams, _, _ = _pair("wgp", "SAMP_WGP")
        z = np.random.default_rng(8).standard_normal((len(xs), 3))
        latent = torch.as_tensor(tw.location(wparams)[:, None] + tw.cholesky(wparams) @ z)
        assert_close(tw.sampler(wparams, samples=3, rng=np.random.default_rng(8)),
                     tw.f_mapping(tw._tensor_params(wparams), latent), "float64")
        with pytest.raises(ValueError, match="covariance"):
            tw.predict(wparams, cov=True)


@pytest.mark.parametrize("kind", ["wgp"])
def test_logpredictive_prior_and_predictor_match_jax(kind):
    with floatx("float32"):
        jp, tp, params, xs, ys = _pair(kind, f"LP_{kind.upper()}")
        want = float(jp.logpredictive(params, vector=ys, noise=True))
        assert_close(float(tp.logpredictive(params, vector=ys, noise=True)), want)
        pr = tp.predictor(params)
        assert_close(float(pr.logpredictive(ys, xs)), want)
        assert_close(float(pr(xs, distribution=True)["logpredictive"](ys)), want)
        # the JAX Predictor's fused bundle: every statistic from one compile
        jpr = jp.predictor(params)
        flags = dict(mean=True, std=True, median=True, quantiles=True)
        for prior in (True, False):
            jwant = dict(jpr.predict(xs, prior=prior, **flags))
            assert_close(dict(tp.predict(params, prior=prior, **flags)), jwant,
                         err_msg=f"prior={prior}")
            assert_close(dict(pr(xs, prior=prior, **flags)), jwant, err_msg=f"prior={prior}")
        assert_close(pr.median(xs), jwant["median"])
        jprior = float(jp.logpredictive(params, vector=ys, prior=True, noise=True))
        assert_close(float(pr.logpredictive(ys, xs, prior=True)), jprior)


def test_batch_predict_average_and_scores_match_jax():
    with floatx("float64"):
        jp, tp, params, xs, _ = _pair("wgp", "AVS_WGP")
        u0 = jp.active.dict_to_array(params)
        rows = u0 + 0.05 * np.random.default_rng(6).standard_normal((3, len(u0)))
        flags = dict(std=False, median=True, prior=True)
        assert_close(dict(tp.batch_predict(rows, **flags)), dict(jp.batch_predict(rows, **flags)),
                     "float64")
        jg, tg, gparams, _, _ = _pair("gp", "AVC_GP")
        grows = jg.active.dict_to_array(gparams) + 0.05 * np.random.default_rng(7).standard_normal(
            (3, jg.active.ndim))
        assert_close(dict(tg.batch_predict(grows, cov=True, std=False)),
                     dict(jg.batch_predict(grows, cov=True, std=False)), "float64")
        jdt = g3.chains_to_datatrace(jp, rows[None], burnin_tol=None)
        tdt = g3t.chains_to_datatrace(tp, rows[None], burnin_tol=None)
        want = dict(jp.average(jdt, median=True))
        assert "_l1" in want and "_l2" in want
        got = tp.average(tdt, median=True)
        assert_close(dict(got), want, "float64")
        want_ap = dict(jp.averaged_predictor(jdt).predict(xs, scores=True))
        assert "_l1" in want_ap
        assert_close(dict(tp.averaged_predictor(tdt).predict(xs, scores=True)), want_ap,
                     "float64")
        with pytest.raises(NotImplementedError, match="item 7"):
            tp.batch_predict(rows, samples=2)
