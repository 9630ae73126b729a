"""Port parity of the datatrace toolkit's host half
(``g3py_tpu_torch/bayesian/average.py`` and ``bayesian/density.py``)
against the JAX package and scikit-learn, which the JAX package calls:

* the kernel density's ``score_samples`` for its six kernels and its draws
  (gaussian, tophat) from the same numpy ``RandomState``;
* the two mixtures on three separated blobs of unequal size: labels equal,
  weights and means within 1e-2 relative, and ``cluster_datatrace``'s
  size-ordered labels equal the JAX package's;
* ``datatrace_to_kde``/``kde_to_datatrace`` (float64 at 1e-10),
  ``errors_datatrace`` (float64 statistics stored as float32, as the JAX
  package stores them; the rows one batched K1/K2 evaluation, a non-finite
  row NaN),
  ``find_candidates``, ``marginal_datatrace`` and ``conditional_datatrace``
  on the same datatraces.
"""

import numpy as np
import pandas as pd
import pytest
from sklearn import mixture
from sklearn.neighbors import KernelDensity as SkKernelDensity

import g3py_tpu as g3
import g3py_tpu_torch as g3t
from g3py_tpu_torch.bayesian import density

from torch_parity import KernelSpy, floatx, jax_eager

KERNELS = ["gaussian", "tophat", "epanechnikov", "exponential", "linear", "cosine"]


def _points(n=300, d=3, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d))


@pytest.mark.parametrize("kernel", KERNELS)
def test_kde_score_samples_match_sklearn(kernel):
    """The log density at the fitted rows and near them (inside every
    compact kernel's support) at 1e-10."""
    x = _points()
    q = x[::3] + 0.05
    want = SkKernelDensity(kernel=kernel, bandwidth=0.4).fit(x).score_samples(q)
    got = density.KernelDensity(kernel=kernel, bandwidth=0.4).fit(x).score_samples(q)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kernel", ["gaussian", "tophat"])
def test_kde_draws_match_sklearn(kernel):
    x = _points(d=4)
    sk = SkKernelDensity(kernel=kernel, bandwidth=0.3).fit(x)
    ours = density.KernelDensity(kernel=kernel, bandwidth=0.3).fit(x)
    np.random.seed(11)
    want = sk.sample(50)
    np.random.seed(11)
    got = ours.sample(50)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours.sample(5, random_state=3), sk.sample(5, random_state=3),
                               rtol=1e-12)
    with pytest.raises(NotImplementedError):
        density.KernelDensity(kernel="linear").fit(x).sample(2)


def _blobs():
    """Three separated blobs of 600, 300 and 100 rows in 4 dims."""
    rng = np.random.default_rng(7)
    parts = [rng.normal(0.0, 1.0, (600, 4)), rng.normal(7.0, 0.8, (300, 4)),
             rng.normal(-7.0, 0.5, (100, 4))]
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("bayesian", [False, True])
def test_mixtures_match_sklearn(bayesian):
    x = _blobs()
    sk_cls = mixture.BayesianGaussianMixture if bayesian else mixture.GaussianMixture
    ours_cls = density.BayesianGaussianMixture if bayesian else density.GaussianMixture
    for n_components in (3, 5):
        np.random.seed(4)
        sk = sk_cls(n_components=n_components, covariance_type="full", max_iter=5000).fit(x)
        np.random.seed(4)
        ours = ours_cls(n_components=n_components, max_iter=5000).fit(x)
        np.testing.assert_array_equal(ours.predict(x), sk.predict(x))
        np.testing.assert_allclose(ours.weights_, sk.weights_, rtol=1e-2, atol=1e-6)
        np.testing.assert_allclose(ours.means_, sk.means_, rtol=1e-2, atol=1e-4)


class _Reg:
    def __init__(self, names):
        self.names = names

    def param_names(self):
        return list(self.names)


class _Proc:
    """What the toolkit reads of a process: its registry's column names."""

    def __init__(self, names):
        self.active = _Reg(names)


@pytest.mark.parametrize("bayesian", [False, True])
def test_cluster_datatrace_matches_jax(bayesian):
    x = _blobs()
    names = [f"h{i}" for i in range(4)]
    cols = {c: x[:, i] for i, c in enumerate(names)}
    burn = np.arange(len(x)) % 10 != 0
    jdt = pd.DataFrame(dict(cols, _burnin=burn))
    tdt = g3t.Datatrace(dict(cols, _burnin=burn))
    jp, tp = _Proc(names), _Proc(names)
    np.random.seed(9)
    g3.cluster_datatrace(jp, jdt, n_components=3, bayesian=bayesian)
    np.random.seed(9)
    g3t.cluster_datatrace(tp, tdt, n_components=3, bayesian=bayesian)
    np.testing.assert_array_equal(tdt["_cluster"], jdt["_cluster"].to_numpy())
    assert np.bincount(tdt["_cluster"]).tolist() == [600, 300, 100]  # 0 the largest
    other = g3t.Datatrace({c: v[::7] for c, v in cols.items()})
    tp._cluster(other)
    np.testing.assert_array_equal(other["_cluster"], tdt["_cluster"][::7])


def _pair(kind, name, n=20):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)

    def build(lib):
        if kind == "gp":
            return lib.GP(space=x, location=lib.Bias(), kernel=lib.SE(x), name=name)
        return lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                       mapping=lib.BoxCoxLinear(np.exp(0.3 * y) + 1.0), name=name)

    y = y if kind == "gp" else np.exp(0.3 * y) + 1.0
    jp, tp = build(g3), build(g3t)
    jp.observed(x, y)
    tp.observed(x, y)
    return jp, tp, x, y


def _rows(tp, count=6, seed=3):
    u = tp.active.dict_to_array(tp.params_default)
    rng = np.random.default_rng(seed)
    return u[None, :] + 0.1 * rng.standard_normal((count, len(u)))


def test_kde_round_trip_matches_jax():
    """``datatrace_to_kde`` over the same datatrace, then
    ``kde_to_datatrace`` from the same global RandomState: the same draws
    and logps (float64, 1e-10)."""
    with floatx("float64"), jax_eager():
        jp, tp, _, _ = _pair("gp", "KDE_GP")
        rows = _rows(tp, 40).reshape(4, 10, -1)
        ll = tp.logp_chain(rows.reshape(40, -1)).reshape(4, 10)
        jdt = g3.chains_to_datatrace(jp, rows, ll=ll, burnin_tol=None)
        tdt = g3t.chains_to_datatrace(tp, rows, ll=ll, burnin_tol=None)
        jk = g3.datatrace_to_kde(jp, jdt, kernel="gaussian", bandwidth=0.05)
        tk = g3t.datatrace_to_kde(tp, tdt, kernel="gaussian", bandwidth=0.05)
        assert tk.min_ll == jk.min_ll
        np.random.seed(21)
        want = g3.kde_to_datatrace(jp, jk, nsamples=12)
        np.random.seed(21)
        got = g3t.kde_to_datatrace(tp, tk, nsamples=12)
        assert got.columns == list(want.columns)
        cols = tp.active.param_names() + ["_ll"]
        np.testing.assert_allclose(got[cols], want[cols].to_numpy(), rtol=1e-10, atol=1e-10)
        assert got["_burnin"].all() and len(got) == 12


@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_errors_datatrace_matches_jax(kind, monkeypatch):
    """Every row's errors (a NaN row included) from a float64 evaluation,
    stored as float32 as the JAX package stores them (so compared at 1e-6),
    the rows one batched factorization (K2 once) and the statistics' cross
    grams one batched K1 call each."""
    with floatx("float64"), jax_eager():
        jp, tp, x, y = _pair(kind, "ERR_" + kind)
        rows = _rows(tp)
        rows[4, 0] = np.nan
        names = tp.active.param_names()
        jdt = pd.DataFrame(rows, columns=names)
        tdt = g3t.Datatrace({c: rows[:, i] for i, c in enumerate(names)})
        kw = dict(space=x[:12], hidden=y[:12], nlpd=True, mse=False)
        g3.errors_datatrace(jp, jdt, **kw)
        spy = KernelSpy(monkeypatch)
        g3t.errors_datatrace(tp, tdt[np.arange(2)].copy(), **kw)
        two = spy.take()
        g3t.errors_datatrace(tp, tdt, **kw)
        # the same launches for 2 rows as for 6: the rows' factors one K2
        # call, each gram one batched K1 call
        assert spy.take() == two and two[1] == 1
        for c in ("_l1", "_l2", "_nlpd"):
            np.testing.assert_allclose(tdt[c], jdt[c].to_numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=c, equal_nan=True)
        assert np.isnan(tdt["_l1"][4]) and np.isfinite(np.delete(tdt["_l1"], 4)).all()
        # the float32 columns against the float64 statistic, single rows
        for r in (0, 3):
            one = tp.error_l2(rows[r], x[:12], vector=y[:12], array=True)
            np.testing.assert_allclose(tdt["_l2"][r], float(one), rtol=1e-6)


def test_errors_datatrace_mse_and_prior_match_jax():
    """``_mse`` (of the observed outputs, the same for every row) and an
    unobserved process (the prior's errors)."""
    with floatx("float64"), jax_eager():
        jp, tp, x, y = _pair("gp", "ERRP")
        rows = _rows(tp, 3)
        names = tp.active.param_names()
        jdt = pd.DataFrame(rows, columns=names)
        tdt = g3t.Datatrace({c: rows[:, i] for i, c in enumerate(names)})
        g3.errors_datatrace(jp, jdt, hidden=y, l1=False, l2=True, mse=True)
        g3t.errors_datatrace(tp, tdt, hidden=y, l1=False, l2=True, mse=True)
        for c in ("_l2", "_mse"):
            np.testing.assert_allclose(tdt[c], jdt[c].to_numpy(), rtol=1e-6, err_msg=c)
        jq = g3.GP(space=x, location=g3.Bias(), kernel=g3.SE(x), name="ERRQ")
        tq = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="ERRQ")
        names = tq.active.param_names()
        jd2 = pd.DataFrame(rows, columns=names)
        td2 = g3t.Datatrace({c: rows[:, i] for i, c in enumerate(names)})
        g3.errors_datatrace(jq, jd2, hidden=y)
        g3t.errors_datatrace(tq, td2, hidden=y)
        np.testing.assert_allclose(td2["_l1"], jd2["_l1"].to_numpy(), rtol=1e-6)


def test_errors_datatrace_requires_a_value_a_row(monkeypatch):
    """Only ``_mse`` is one value for all rows: a row statistic that loses
    the row axis raises instead of being copied to every row."""
    with floatx("float64"):
        x = np.linspace(0, 1, 20)[:, None]
        y = np.sin(6 * x[:, 0])
        tp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="ERRS")
        tp.observed(x, y)
        rows = _rows(tp, 3)
        names = tp.active.param_names()
        tdt = g3t.Datatrace({c: rows[:, i] for i, c in enumerate(names)})
        g3t.errors_datatrace(tp, tdt, hidden=y, l1=False, l2=False, mse=True)
        assert len(set(tdt["_mse"].tolist())) == 1
        inner = tp.th_error_l2

        def collapsed(prior=False, noise=False):
            fn = inner(prior=prior, noise=noise)
            return lambda *args: fn(*args).mean()

        monkeypatch.setattr(tp, "th_error_l2", collapsed)
        with pytest.raises(ValueError, match="th_error_l2 gave shape"):
            g3t.errors_datatrace(tp, tdt, hidden=y, l1=False, l2=True)


def _toolkit_frames():
    rng = np.random.default_rng(2)
    n = 60
    cols = {"a": rng.standard_normal(n), "b": rng.standard_normal(n),
            "a_log_": rng.standard_normal(n)}
    cols["a"][5] = cols["a"][4]  # a duplicated row
    cols["b"][5] = cols["b"][4]
    cols["a_log_"][5] = cols["a_log_"][4]
    extra = {"_nchain": np.repeat(np.arange(3), 20), "_niter": np.tile(np.arange(20), 3),
             "_burnin": np.arange(n) % 20 > 3, "_ll": rng.standard_normal(n),
             "_l1": rng.uniform(size=n), "_l2": rng.uniform(size=n),
             "_cluster": rng.integers(0, 3, n)}
    data = dict(cols, **extra)
    return pd.DataFrame(data), g3t.Datatrace(data)


def test_find_candidates_matches_jax():
    jdt, tdt = _toolkit_frames()
    for kw in (dict(ll=2, l1=1, l2=1), dict(ll=1, mean=True, median=True),
               dict(ll=3, by_cluster=False, l2=2)):
        want = g3.find_candidates(jdt, **kw)
        got = g3t.find_candidates(tdt, **kw)
        assert got.columns == list(want.columns), kw
        assert list(got.index) == list(want.index), kw
        for c in want.columns:
            np.testing.assert_allclose(np.asarray(got[c], dtype=np.float64),
                                       want[c].to_numpy(dtype=np.float64), rtol=1e-12,
                                       equal_nan=True, err_msg=f"{kw} {c}")
    np.random.seed(5)
    want = g3.find_candidates(jdt, ll=1, rand=3)
    np.random.seed(5)
    got = g3t.find_candidates(tdt, ll=1, rand=3)
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got["_ll"], want["_ll"].to_numpy(), rtol=1e-12)


def test_marginal_and_conditional_match_jax():
    jdt, tdt = _toolkit_frames()
    for kw in (dict(items=["b", "a", "zz"]), dict(like="a"), dict(regex="^_l"),
               dict(drop=["_l1", "_l2"])):
        want = g3.marginal_datatrace(jdt, **kw)
        got = g3t.marginal(tdt, **kw)
        assert got.columns == list(want.columns), kw
        np.testing.assert_allclose(np.asarray(got[got.columns], dtype=float),
                                   want.to_numpy(dtype=float), rtol=0)
    np.random.seed(8)
    want = g3.marginal_datatrace(jdt, like="a", samples=7)
    np.random.seed(8)
    got = g3t.marginal_datatrace(tdt, like="a", samples=7)
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    np.testing.assert_array_equal(got["a"], want["a"].to_numpy())
    want = g3.conditional_datatrace(jdt, lambda df: df["_l1"] < 0.3)
    got = g3t.conditional(tdt, lambda dt: dt["_l1"] < 0.3)
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    np.testing.assert_array_equal(got["_ll"], want["_ll"].to_numpy())
    # the datatrace panels: a kde and a trace a variable
    fig = g3t.plot_datatrace(tdt, varnames=["a"])
    assert len(fig.axes) == 2
    g3t.utils.plots.pyplot().close("all")
