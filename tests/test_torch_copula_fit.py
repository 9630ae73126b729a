"""Port parity of the copula family's draws and fit with the JAX package:
the draws from the same numpy Generator and the Monte-Carlo moments over
them, logp and dlogp through a StudentT marginal's betainc CDF, the JAX
package's ``ValueError`` for ``dlogp`` through a StudentT
marginal whose degrees of freedom are a hyperparameter (betainc has no
gradient in a or b), and ``find_MAP`` (the logp, dlogp, correlation and
latent posterior are tests/test_torch_copula.py's).

Tolerances: float64 against JAX x64 at rtol/atol 1e-10, float32 at rtol
1e-4 / atol 1e-5 (``torch_parity``); ``find_MAP``'s optimum at 1e-6
relative in logp."""

import numpy as np
import pytest

import g3py_tpu_torch as g3t

from test_torch_copula import _data, _marginal, _pair
from torch_parity import assert_close, floatx


def test_draws_and_moments():
    """The sampler from the same numpy Generator (the JAX package draws one
    length-m vector a sample, the port all at once: the same normals), and
    the Monte-Carlo mean and std over those draws."""
    with floatx("float64"):
        x, y = _data()
        jp, tp = _pair("CSTP", "CPD", x, y, "t_fixed")
        params = jp.params_default
        xq = np.linspace(0, 8, 5).astype(np.float32).reshape(-1, 1)
        for prior in (False, True):
            want = jp.sampler(params, space=xq, samples=6, prior=prior,
                              rng=np.random.default_rng(2))
            got = tp.sampler(params, space=xq, samples=6, prior=prior,
                             rng=np.random.default_rng(2))
            assert got.shape == (5, 6)
            assert_close(got, np.asarray(want), "float64")
        # an int ``simulations`` is the number of draws of each moment
        draws = np.asarray(jp.sampler(params, space=xq, samples=40,
                                      rng=np.random.default_rng(5)))
        assert_close(tp.mean(params, space=xq, simulations=40, rng=np.random.default_rng(5)),
                     draws.mean(axis=1), "float64")
        assert_close(tp.std(params, space=xq, simulations=40, rng=np.random.default_rng(5)),
                     draws.std(axis=1), "float64")


def test_studentt_marginal_logp_dlogp():
    """CSTP through the StudentT marginal's betainc CDF (its gradient in x),
    float32, against the JAX package."""
    with floatx("float32"):
        x, y = _data()
        jp, tp = _pair("CSTP", "CPS", x, y, "t_fixed")
        params = {k: np.asarray(v) for k, v in jp.params_default.items()}
        assert_close(tp.logp(params), np.asarray(jp.logp(params)))
        u = jp.active.dict_to_array(params)
        assert_close(tp.dlogp(u), np.asarray(jp.dlogp(u)))


def test_studentt_marginal_degree_gradient_raises():
    """CGP(marginal=StudentT(nu=Bias)): logp as the JAX package's, and
    dlogp raises its ``ValueError`` (betainc has no gradient in a or b);
    ``find_MAP`` then goes on without a gradient, as in the JAX package."""
    with floatx("float64"):
        x, y = _data()
        jp, tp = _pair("CGP", "CPT", x, y, "t_param")
        params = jp.params_default
        assert_close(tp.logp(params), np.asarray(jp.logp(params)), "float64")
        u = jp.active.dict_to_array(params)
        with pytest.raises(ValueError, match="Betainc gradient with respect to a and b"):
            jp.dlogp(u)
        with pytest.raises(ValueError, match="Betainc gradient with respect to a and b"):
            tp.dlogp(u)


def test_marginal_process_as_marginal_and_find_map():
    """A MarginalProcess handed as the marginal gives its density; the
    CGP's ``find_MAP`` raises the logp as the JAX package's does."""
    x, y = _data(n=16)
    mp = g3t.MP(space=x, density=_marginal(g3t, x, "normal"), name="CMP")
    cgp = g3t.CGP(space=x, kernel=g3t.SE(x), marginal=mp, name="CGPM")
    assert cgp.f_density is mp.f_density
    with floatx("float64"):
        jp, tp = _pair("CGP", "CPF", x, y)
        jmap = jp.find_MAP(points=1, powell=False, display=False)
        tmap = tp.find_MAP(points=1, powell=False, display=False)
        lj, lt = float(jp.logp(jmap)), tp.logp(tmap)
        assert lt > tp.logp(tp.params_default)
        np.testing.assert_allclose(lt, lj, rtol=1e-6)
