"""Port parity: hypers (means, mappings, every prior and transform,
Freedom), the registry bijection and ``params_from_jax``."""

import jax
import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.utils import params_from_jax

from torch_parity import check, floatx, assert_close

NAMES = ["float32", "float64"]


def _data(n=20, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.abs(np.sin(x[:, 0])) + 0.5 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def _boxcox_pair(name):
    jm, tm = g3.BoxCoxLinear(name=name), g3t.BoxCoxLinear(name=name)
    jm.check_hypers("P_")
    tm.check_hypers("P_")
    return jm, tm


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("power", [0.7, 1e-6])
def test_boxcox_linear(name, power):
    jm, tm = _boxcox_pair("BC")
    _, y = _data()
    keys = [p.name for p in jm.hypers]
    assert keys == [p.name for p in tm.hypers]

    def both(method):
        def jfn(yy, shift, scale, pw):
            return getattr(jm, method)(dict(zip(keys, (shift, scale, pw))), yy)

        def tfn(yy, shift, scale, pw):
            return getattr(tm, method)(dict(zip(keys, (shift, scale, pw))), yy)
        return jfn, tfn

    args = (y, np.array(0.3), np.array(1.4), np.array(power))
    for method in ("inv", "logdet_dinv"):
        check(*both(method), *args, name=name)
    if power > 1e-5:
        check(*both("__call__"), y - 0.4, *args[1:], name=name)


def test_means():
    x, y = _data()
    jb, tb = g3.Bias(x), g3t.Bias(x)
    jb.check_hypers("P_")
    tb.check_hypers("P_")
    params = {"P_Bias_Bias": np.float32(0.7)}
    assert_close(tb(params, torch.as_tensor(x)), np.asarray(jb(params, x)))
    assert_close(g3t.Zero()(params, torch.as_tensor(x)), np.zeros(len(x)))
    assert jb.default_hypers_dims(x, y)[jb.bias] == pytest.approx(
        float(tb.default_hypers_dims(x, y)[tb.bias]))


def _wgp_pair(name, x, y):
    jw = g3.WGP(space=x, location=g3.Bias(), kernel=g3.SE(x),
                mapping=g3.BoxCoxLinear(y), name=name)
    tw = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x),
                 mapping=g3t.BoxCoxLinear(y), name=name)
    jw.observed(x, y)
    tw.observed(x, y)
    return jw, tw


def test_registry_names_order_and_bijection():
    x, y = _data()
    jw, tw = _wgp_pair("REG_WGP", x, y)
    jreg, treg = jw.active, tw.active
    assert list(treg.params_spec) == list(jreg.params_spec)
    assert treg.param_names() == jreg.param_names()
    assert treg.slices() == jreg.slices()
    assert treg.ndim == jreg.ndim
    jdef, tdef = jw.params_default, tw.params_default
    assert list(tdef) == list(jdef)
    for k in jdef:
        np.testing.assert_allclose(tdef[k], jdef[k], rtol=1e-6)
    np.testing.assert_allclose(treg.dict_to_array(tdef), jreg.dict_to_array(jdef), rtol=1e-6)
    np.testing.assert_array_equal(treg.dict_to_array(treg.params_test),
                                  jreg.dict_to_array(jreg.params_test))
    u = jreg.dict_to_array(jdef)
    for k, v in treg.array_to_dict(u).items():
        np.testing.assert_allclose(v, jreg.array_to_dict(u)[k], rtol=1e-6)


def test_logp_prior_and_wall():
    x, y = _data()
    jw, tw = _wgp_pair("PRI_WGP", x, y)
    params = dict(jw.params_default)
    assert float(tw.active.logp_prior_dict(params)) == float(jw.active.logp_prior_dict(params))
    params["PRI_WGP_SE_var"] = np.float32(1e-7)  # below the FlatExp wall
    assert float(tw.active.logp_prior_dict(params)) == pytest.approx(-1e30)
    assert float(jw.active.logp_prior_dict(params)) == pytest.approx(-1e30)


def test_params_from_jax():
    x, y = _data()
    jw, tw = _wgp_pair("PFJ_WGP", x, y)
    jp = {k: np.asarray(v) for k, v in jw.params_random(sigma=0.2, rng=np.random.default_rng(1)).items()}
    got = params_from_jax(tw, jp)
    assert list(got) == list(tw.active.params_spec)
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), jp[k].astype(np.float32))
    with floatx("float64"):
        assert params_from_jax(tw, jp)["PFJ_WGP_SE_rate"].dtype == torch.float64
    missing = dict(jp)
    missing.pop("PFJ_WGP_SE_var")
    with pytest.raises(KeyError, match="PFJ_WGP_SE_var"):
        params_from_jax(tw, missing)
    with pytest.raises(KeyError, match="unexpected"):
        params_from_jax(tw, dict(jp, extra_hyper=np.float32(1.0)))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tw, dict(jp, PFJ_WGP_SE_rate=np.ones(2, np.float32)))


PRIORS = {"Flat": (), "Null": (), "ExpFlat": (), "FlatExp": (), "FlatPos": (),
          "FlatExpId": (), "Exponential": (2.0,), "Uniform": (-1.0, 3.0)}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_priors_and_transforms(prior, name):
    """Every prior: its transform both ways, its unconstrained ``logp`` and
    natural ``logp_natural`` (one term per row of a (R, size) stack; the JAX
    package's on each row) and its test value."""
    jp = getattr(g3.hypers, prior)(*PRIORS[prior])
    tp = getattr(g3t.hypers, prior)(*PRIORS[prior])
    assert type(tp.transform).__name__ == type(jp.transform).__name__
    rng = np.random.default_rng(3)
    u = rng.uniform(-2.5, 2.5, (4, 3))
    u[1, 0] = -20.0  # below FlatExp's wall
    with floatx(name):
        v = np.asarray(jp.transform.backward(jax.numpy.asarray(u.astype(name))))
        assert_close(tp.transform.backward(torch.as_tensor(u.astype(name))), v, name)
        inside = v[2:]  # rows clear of the walls
        assert_close(tp.transform.forward(inside), np.asarray(jp.transform.forward(inside)),
                     name)
        assert_close(tp.logp(torch.as_tensor(u.astype(name))),
                     np.array([float(jp.logp(jax.numpy.asarray(r))) for r in u.astype(name)]),
                     name)
        assert_close(tp.logp_natural(torch.as_tensor(v.copy())),
                     np.array([float(jp.logp_natural(jax.numpy.asarray(r))) for r in v]), name)
        np.testing.assert_array_equal(tp.testval((2,)), jp.testval((2,)))


def test_freedom_and_aliases():
    x, y = _data()
    jf, tf = g3.Freedom(), g3t.Freedom()
    jf.check_hypers("P_")
    tf.check_hypers("P_")
    assert [p.name for p in tf.hypers] == [p.name for p in jf.hypers] == ["P_Freedom_degree"]
    assert type(tf.degree.prior).__name__ == type(jf.degree.prior).__name__ == "FlatExp"
    assert float(tf.default_hypers(x, y)[tf.degree]) == float(
        jf.default_hypers(x, y)[jf.degree]) == len(y)
    params = {"P_Freedom_degree": np.float32(7.0)}
    assert_close(tf(params), np.asarray(jf(params)))
    fixed = g3t.Freedom(degree=3.0, bound=1.0)
    fixed.check_hypers("P_")
    assert fixed.hypers == [] and float(fixed({})) == 4.0
    assert g3t.PositiveFlat is g3t.FlatPos and g3t.NonTransformLog is g3t.hypers.LogTransform
    assert g3t.UniformPrior is g3t.hypers.Uniform and g3t.Uniform is g3t.models.Uniform
