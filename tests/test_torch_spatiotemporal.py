"""Port parity of the separable spatio-temporal GP
(``g3py_tpu_torch/models/spatiotemporal.py``) against the JAX package in
float64 at 1e-10: ``SpatioTemporalSSGP`` on 4 sites in 2-D (MAT32 in time x
SE over the sites) — the hyper names and defaults, logp and dlogp, the
field off the sites (posterior and prior) against the JAX package's, on the
sites against the site rows' own statistics, ``task_correlations`` — and
the K1/K2 calls an evaluation (``torch_parity.KernelSpy``): logp and dlogp
one K1 site gram and one K2 factorization, the field one K1 site gram, one
K2 and one K1 cross gram.  The sparse variant is
``tests/test_torch_spatiotemporal_sparse.py``'s."""

import numpy as np

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import (KernelSpy, assert_close, floatx, jax_compiled_method, jax_logp_dlogp,
                          to_numpy)

F64 = "float64"
SITES = np.array([[0.0, 0.0], [1.0, 0.3], [2.5, -0.4], [0.7, 1.6]])


def site_rows(lib, seed=4):
    """A series a site, scaled down away from site 0, in (t, site) rows."""
    ts, ys = [], []
    for p in range(len(SITES)):
        rng = np.random.default_rng(seed + p)
        t = np.sort(rng.uniform(0, 10, 6 + p)).reshape(-1, 1)
        ts.append(t)
        ys.append((np.sin(t[:, 0]) + 0.1 * rng.standard_normal(len(t))) * np.exp(-p / 3.0))
    return lib.stack_outputs(ts, ys)


def stssgp(lib, name="ST"):
    x, y = site_rows(lib)
    st = lib.SpatioTemporalSSGP(space=x, location=lib.Bias(), kernel=lib.MAT32(x[:, :1]),
                                space_kernel=lib.SE(SITES), sites=SITES, name=name)
    st.observed(x, y)
    return st


def _nudged(params, seed=0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) * (1.0 + 0.05 * rng.uniform(-1, 1, np.shape(v)))
            for k, v in params.items()}


def test_stssgp_matches_jax():
    with floatx(F64):
        jp, tp = stssgp(g3), stssgp(g3t)
        assert [q.name for q in tp.active.ordered_params] == \
            [q.name for q in jp.active.ordered_params]
        for k, v in jp.params_default.items():
            np.testing.assert_array_equal(tp.params_default[k], np.asarray(v), err_msg=k)
        p = _nudged(jp.params)
        value, grad = jax_logp_dlogp(jp, p)
        assert_close(tp.logp(p), value, F64)
        assert_close(tp.dlogp(p), grad, F64)
        tq = np.linspace(0.0, 10.0, 5)
        xq = np.array([[0.5, 0.5], [1.8, 0.0], [-1.0, 2.0], [0.7, 1.6], [3.0, 3.0]])
        jax_compiled_method(jp, "_run_smoother_weights")
        assert_close(tp.field(tq, xq, params=p), jp.field(tq, xq, params=p), F64)
        assert_close(tp.field(tq, xq, params=p, prior=True),
                     jp.field(tq, xq, params=p, prior=True), F64)
        assert_close(tp.task_correlations(p), jp.task_correlations(p), F64)


def test_stssgp_field_on_the_sites_is_the_site_rows():
    """At a site's coordinates the interpolation is that site's latent row
    (no residual): the field is the site rows' mean without the per-site
    bias, and their variance."""
    with floatx(F64):
        tp = stssgp(g3t)
        p = _nudged(tp.params, seed=1)
        tq = np.linspace(0.5, 9.5, 4)
        for site in range(len(SITES)):
            m, v = tp.field(tq, np.repeat(SITES[site:site + 1], len(tq), axis=0), params=p)
            rows = g3t.with_output(tq[:, None], site)
            bias = np.asarray(p[tp.f_mixing.b.name])[site]
            assert_close(m, to_numpy(tp.mean(p, rows)) - bias, F64)
            assert_close(v, to_numpy(tp.variance(p, rows)), F64)


def test_stssgp_kernel_calls_an_evaluation(monkeypatch):
    with floatx(F64):
        tp = stssgp(g3t, name="ST_spy")
        spy = KernelSpy(monkeypatch)
        p = tp.params
        tp.logp(p)
        assert spy.take() == (1, 1)
        tp.dlogp(p)
        assert spy.take() == (1, 1)
        tp.field(np.linspace(0, 10, 6), np.full((6, 2), 0.4), params=p)
        assert spy.take() == (2, 1)
        tp.mean(p, g3t.with_output(np.linspace(0, 10, 6)[:, None], 2))
        assert spy.take() == (1, 1)
