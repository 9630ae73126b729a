"""The process surface of the port against the JAX package's: every public
attribute of the JAX package's ``GaussianProcess`` exists on the port's
(but ``executed``, a count of JAX compiles), and the registry views and bound statistics — ``params_test``,
``ndim``, ``params_process``, ``params_random``, ``transform_params``,
``transformations``, ``potentials``, ``mapping_inv``, ``cross_mean``,
``error_l1``, ``error_l2``, ``error_mse`` — give the JAX package's values
at 1e-10 in float64."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx, jax_eager, nudged, process_pair

SKIPPED = {"executed"}
#: item 16's names (the band-sharded engine): required
DISTRIBUTED = {"nll_distributed", "predictor_distributed"}
#: item 15's names (plots, widgets, persistence, the fan-out): required
ITEM15 = {"describe", "fit_splits", "th_loglike_masked_fn", "params_widget", "widget", "save",
          "plot", "plot_concentration", "plot_datatrace", "plot_distribution",
          "plot_distribution2D", "plot_hidden", "plot_kernel", "plot_location", "plot_mapping",
          "plot_model", "plot_observations", "plot_space", "widget_params"}
#: the matrix-free slice's names: required
ITERATIVE = {"nll_iterative", "predictor_iterative"}


def _data(n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 6.0, n)).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    xq = np.linspace(-0.5, 6.5, 7).reshape(-1, 1)
    yq = np.sin(xq[:, 0])
    return x, y, xq, yq


def _pair(name="A"):
    x, y, xq, yq = _data()
    jp, tp = process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                             name=name), x, y)
    return jp, tp, xq, yq


def _public(obj):
    return {a for a in dir(obj) if not a.startswith("_")}


def test_every_public_attribute_exists():
    with floatx("float64"):
        jp, tp, _, _ = _pair("SURF")
        missing = sorted(_public(jp) - SKIPPED - _public(tp))
    assert not missing, missing
    assert ITERATIVE <= _public(tp)
    assert ITEM15 <= _public(tp)
    assert DISTRIBUTED <= _public(tp)
    # the skip list names only what the JAX package has
    assert SKIPPED <= _public(jp)


def test_registry_views():
    with floatx("float64"):
        jp, tp, _, _ = _pair("VIEW")
        assert tp.ndim == jp.ndim
        assert tp.model is tp.active
        assert_close(dict(tp.params_test), dict(jp.params_test), "float64")
        assert tp.transformations == jp.transformations
        assert sorted(tp.potentials) == sorted(jp.potentials)
        params = nudged(jp.params_default)
        assert_close(dict(tp.transform_params(params)), dict(jp.transform_params(params)),
                     "float64")
        want = jp.params_random(mean=params, sigma=0.2, rng=np.random.default_rng(3))
        got = tp.params_random(mean=params, sigma=0.2, rng=np.random.default_rng(3))
        assert_close(dict(got), dict(want), "float64")


def test_params_process():
    """Params of one process mapped onto another by name prefix, the
    current values kept for the names the other lacks."""
    with floatx("float64"):
        x, y, _, _ = _data()
        pairs = {}
        for lib in (g3, g3t):
            src = lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x), name="SRC")
            dst = lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x) + lib.LIN(x),
                         name="DST")
            for proc in (src, dst):
                proc.observed(x, y)
            pairs[lib] = (src, dst)
        (js, jd), (ts, td) = pairs[g3], pairs[g3t]
        params = nudged(js.params_default, 0.3)
        want = jd.params_process(js, params)
        got = td.params_process(ts, params)
        assert list(got) == list(want)
        assert_close(dict(got), {k: np.asarray(v) for k, v in want.items()}, "float64")


@pytest.mark.parametrize("prior", [False, True])
def test_bound_statistics(prior):
    """mapping_inv, cross_mean (the process's kernel and an explicit
    cross kernel), error_l1, error_l2 and error_mse at nudged params, on
    the posterior and the prior branch."""
    with floatx("float64"), jax_eager():
        jp, tp, xq, yq = _pair("STAT")
        params = nudged(jp.params_default)
        kw = dict(prior=prior)
        for name in ("error_l1", "error_l2"):
            assert_close(getattr(tp, name)(params, xq, vector=yq, **kw),
                         getattr(jp, name)(params, xq, vector=yq, **kw), "float64",
                         err_msg=name)
        # the mse compares vector with the observed outputs
        vec = jp.outputs + 0.05
        assert_close(tp.error_mse(params, vector=vec, **kw),
                     jp.error_mse(params, vector=vec, **kw), "float64", err_msg="error_mse")
        assert_close(tp.cross_mean(params, xq, **kw), jp.cross_mean(params, xq, **kw),
                     "float64", err_msg="cross_mean")
        # a cross kernel over the process's own hypers: half its signal kernel
        assert_close(tp.cross_mean(params, xq, cross_kernel=0.5 * tp.f_kernel, **kw),
                     jp.cross_mean(params, xq, cross_kernel=0.5 * jp.f_kernel, **kw),
                     "float64", err_msg="cross_mean(cross_kernel)")
        assert_close(tp.mapping_inv(params), jp.mapping_inv(params), "float64",
                     err_msg="mapping_inv")


def test_construction_attributes():
    with floatx("float64"):
        jp, tp, _, _ = _pair("CONS")
        assert tp.description == jp.description
        assert tp.precompile == jp.precompile
        assert tp.distribution.__name__ == jp.distribution.__name__
        assert dict(tp.compiles) == {}
        assert tp.np_hidden is None and jp.np_hidden is None
