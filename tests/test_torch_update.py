"""Port parity of ``Predictor.updated`` (the block-Cholesky streaming update,
``EllipticalProcess._posterior_state_update_pure``): against the JAX
package's ``updated`` and against a fresh Predictor on all the data, with
one m x m factorization and no n x n one; the refusal of white-noise terms
inside the signal kernel; the stale predictor; chained updates and the
Student-t process (as the JAX package's
``test_streaming_update_no_refactorization``)."""

import numpy as np
import pytest

import g3py_tpu_torch as g3t

from torch_parity import KernelSpy, assert_close, floatx, jax_eager, nudged, process_pair

STATS = dict(quantiles=True, var=True, quantiles_noise=True)


def _data(n=40, m=8, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 30, n + m)).reshape(-1, 1)
    y = np.sin(0.5 * x[:, 0]) + 0.1 * rng.standard_normal(n + m)
    sel = rng.permutation(n + m)
    old, new = np.sort(sel[:n]), np.sort(sel[n:])
    xq = np.linspace(-1, 31, 12).reshape(-1, 1)
    return x, y, old, new, xq


@pytest.mark.parametrize("name", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["GP", "TP"])
def test_updated_matches_jax_and_a_fresh_predictor(kind, name, monkeypatch):
    x, y, old, new, xq = _data()
    with floatx(name), jax_eager():
        jp, tp = process_pair(lambda lib: getattr(lib, kind)(
            space=x, location=lib.Bias(), kernel=lib.SE(x), name="UP" + kind),
            x[old], y[old])
        params = nudged(jp.params_default)
        tparams = g3t.params_from_jax(tp, params)
        jpr, tpr = jp.predictor(params), tp.predictor(tparams)
        spy = KernelSpy(monkeypatch)
        tpr2 = tpr.updated(x[new], y[new])
        k1, k2 = spy.take()
        # the cross gram and the new block's gram; one m x m factorization
        assert (k1, k2) == (2, 1), (k1, k2)
        assert tpr2.state["_state_obs_linv"].shape == (len(x), len(x))
        got = tpr2(xq, **STATS)
        want = jpr.updated(x[new], y[new])(xq, **STATS)
        assert_close(dict(got), dict(want), name)
        np.testing.assert_array_equal(tp.inputs, np.asarray(jp.inputs))
        fresh = tp.predictor(tparams)(xq, **STATS)
        if name == "float64":
            assert_close(dict(got), dict(fresh), name)
        else:  # the JAX test's bound against a refactorization
            for k in fresh:
                scale = float(np.abs(fresh[k]).max()) + 1e-9
                assert float(np.abs(got[k] - fresh[k]).max()) / scale < 2e-3, k


def test_stale_chained_and_refusals():
    x, y, old, new, xq = _data(seed=1)
    with floatx("float32"):
        gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="UPS")
        gp.observed(x[old], y[old])
        pr = gp.predictor()
        pr2 = pr.updated(x[new], y[new])
        with pytest.raises(ValueError, match="rebuild"):
            pr(xq)
        with pytest.raises(ValueError, match="rebuild"):
            pr.updated(x[new], y[new])
        pr3 = pr2.updated(x[new][:3] + 31.0, y[new][:3])
        assert np.all(np.isfinite(pr3(xq)["mean"]))
        assert len(gp.inputs) == len(x) + 3
        for kernel in (g3t.SE(x) + g3t.WN(x), g3t.SE(x) + g3t.KernelNoise(x)):
            wn = g3t.GP(space=x, location=g3t.Bias(), kernel=kernel, name="UPW")
            wn.observed(x[old], y[old])
            with pytest.raises(ValueError, match="white-noise"):
                wn.predictor().updated(x[new], y[new])
