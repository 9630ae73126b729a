"""Port parity of the copula family (CGP, CSTP, TransformedStudentTProcess)
with the JAX package: logp, dlogp, the correlation gram, the latent
posterior, quantiles and median (the draws and the fit are
tests/test_torch_copula_fit.py's).

Tolerances: float64 against JAX x64 at rtol/atol 1e-10, float32 at rtol
1e-4 / atol 1e-5 (``torch_parity``).  The ``cgp_logp_default`` pin is
tests/test_torch_parity.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx

NAMES = ["float32", "float64"]


def _data(n=24, seed=4):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 8, n).astype(np.float32).reshape(-1, 1)
    y = (np.exp(0.3 * np.sin(x[:, 0])) + 1.0 + 0.05 * rng.standard_normal(n)).astype(
        np.float32)
    return x, y


def _marginal(g, x, kind):
    if kind == "normal":
        return g.Normal(mu=g.Bias(x, name="M"), sigma=g.Bias(x, name="S"))
    nu = g.Bias(x, name="N", bias=4.0) if kind == "t_fixed" else g.Bias(x, name="N")
    return g.StudentT(mu=g.Bias(x, name="M"), sigma=g.Bias(x, name="S"), nu=nu)


def _pair(family, name, x, y, marginal="normal"):
    jp = getattr(g3, family)(space=x, kernel=g3.SE(x), marginal=_marginal(g3, x, marginal),
                             name=name)
    tp = getattr(g3t, family)(space=x, kernel=g3t.SE(x), marginal=_marginal(g3t, x, marginal),
                              name=name)
    jp.observed(x, y)
    tp.observed(x, y)
    return jp, tp


@pytest.mark.parametrize("family,name", [("CGP", "float32"), ("CGP", "float64"),
                                         ("CSTP", "float64")])
def test_logp_dlogp_and_correlation(family, name):
    """logp, dlogp and the correlation grams (the StudentT marginal's case
    is tests/test_torch_copula_fit.py's)."""
    with floatx(name):
        x, y = _data()
        jp, tp = _pair(family, "CP", x, y)
        assert list(tp.active.params_spec) == list(jp.active.params_spec)
        params = {k: np.asarray(v) for k, v in jp.params_default.items()}
        u = jp.active.dict_to_array(params)
        assert_close(tp.logp(params), np.asarray(jp.logp(params)), name)
        assert_close(tp.dlogp(u), np.asarray(jp.dlogp(u)), name)
        xq = np.linspace(-1, 9, 7).astype(np.float32).reshape(-1, 1)
        jpar = {k: jnp.asarray(v) for k, v in params.items()}
        tpar = {k: torch.as_tensor(v) for k, v in params.items()}
        xs, qs = x.astype(name), xq.astype(name)
        corr = jax.jit(lambda p: [jp._correlation(p, jnp.asarray(xs)),
                                  jp._correlation(p, jnp.asarray(qs), jnp.asarray(xs))])(jpar)
        assert_close([tp._correlation(tpar, torch.as_tensor(xs)),
                      tp._correlation(tpar, torch.as_tensor(qs), torch.as_tensor(xs))],
                     [np.asarray(c) for c in corr], name)


@pytest.mark.parametrize("family,name", [("CGP", "float32"), ("CGP", "float64"),
                                         ("CSTP", "float64")])
def test_latent_posterior_and_quantiles(family, name):
    with floatx(name):
        x, y = _data()
        jp, tp = _pair(family, "CQ", x, y)
        params = {k: np.asarray(v) for k, v in jp.params_default.items()}
        xq = np.linspace(-1, 9, 7).astype(np.float32).reshape(-1, 1)
        for stat in ("location", "kernel_sd"):
            assert_close(getattr(tp, stat)(params, space=xq),
                         np.asarray(getattr(jp, stat)(params, space=xq)), name)
        flags = dict(mean=False, std=False, quantiles=True, median=True)
        want = {k: np.asarray(v) for k, v in jp.predict(params, space=xq, **flags).items()}
        assert_close(tp.predict(params, space=xq, **flags), want, name)


def test_transformed_studentt_is_the_t_copula():
    """TransformedStudentTProcess is the reference's name for the Student-t
    copula process: the same registry and logp as CSTP."""
    x, y = _data(n=12)
    kw = dict(space=x, kernel=g3t.SE(x), name="TSTP")
    tst = g3t.TransformedStudentTProcess(marginal=_marginal(g3t, x, "normal"), **kw)
    cst = g3t.CSTP(marginal=_marginal(g3t, x, "normal"), **dict(kw, kernel=g3t.SE(x)))
    for proc in (tst, cst):
        proc.observed(x, y)
    assert list(tst.active.params_spec) == list(cst.active.params_spec)
    assert tst.logp(cst.params_default) == cst.logp(cst.params_default)
