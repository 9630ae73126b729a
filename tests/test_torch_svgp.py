"""Port parity of the sparse variational family (``models/svgp.py``)
against the JAX package: the ELBO, its gradient and the moment statistics
of SVP under each scalar likelihood, MulticlassSVP and HeteroscedasticSVP
(latent with and without the covariance, predictive with and without
noise, logpredictive, ``predict_proba``/``predict_class``, the host
sampler and quantiles from the same numpy Generator, ``noise_field``,
the classification scores), ``fit_svgp`` with the JAX package's minibatch
indices injected, the predictor and its params-only export, and the five
``golden_families.json`` pins of the family on the port in float32 at
``test_golden_families.py``'s own rtol/atol of 5e-5.  float64 against JAX
x64 at 1e-10.  A params dict of R rows is one batched K1 pair and one K2
call (the plain versions' call counters), each row equal to its own."""

import json
import os

import numpy as np
import pytest
import torch
from jax import random

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx, jax_logp_dlogp, nudged, process_pair

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_families.json")


def _series(n, seed, span=10.0):
    """``tests/test_golden_families.py``'s series."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, n)).reshape(-1, 1).astype(np.float32)
    y = (np.sin(t[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return t, y


def test_golden_family_pins_on_the_port():
    """The family's pins of ``golden_families.json``, computed by the port
    in float32 from the same workloads (k-means inducing sets through
    sklearn, default params)."""
    with open(GOLDEN) as fh:
        want = json.load(fh)
    got = {}
    x8, y8 = _series(40, seed=9)
    svp = g3t.SVP(space=x8[:4], location=g3t.Bias(), kernel=g3t.SE(x8),
                  likelihood=g3t.GaussianLik(), inducing=8, name="GOLD_SVP")
    svp.observed(x8, y8)
    got["svp_gaussian_elbo"] = svp.logp()
    got["svp_gaussian_dlogp_norm"] = float(np.linalg.norm(svp.dlogp()))
    svt = g3t.SVP(space=x8[:4], location=g3t.Bias(), kernel=g3t.SE(x8),
                  likelihood=g3t.StudentTLik(), inducing=8, name="GOLD_SVT")
    svt.observed(x8, y8)
    got["svp_studentt_elbo"] = svt.logp()
    xc = np.random.default_rng(10).standard_normal((45, 2)).astype(np.float32)
    yc = np.digitize(xc[:, 0] + 0.3 * xc[:, 1], [-0.5, 0.5]).astype(np.float32)
    svc = g3t.MulticlassSVP(space=xc, kernel=g3t.SE(xc), classes=3, inducing=9,
                            name="GOLD_MC")
    svc.observed(xc, yc)
    got["multiclass_elbo"] = svc.logp()
    xh, yh = _series(40, seed=11)
    het = g3t.HeteroscedasticSVP(space=xh, location=g3t.Bias(), kernel=g3t.SE(xh),
                                 inducing=8, name="GOLD_HET")
    het.observed(xh, yh)
    got["heteroscedastic_elbo"] = het.logp()
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=5e-5, atol=5e-5, err_msg=k)


def _data(n=36, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 6.0, n)).reshape(-1, 1)
    f = np.sin(x[:, 0])
    xq = np.linspace(-0.3, 6.3, 6).reshape(-1, 1)
    return x, f, xq, rng


def _targets(kind, f, rng):
    if kind in ("gauss", "studentt"):
        return f + 0.1 * rng.standard_normal(len(f))
    if kind == "bernoulli":
        return (f + 0.3 * rng.standard_normal(len(f)) > 0).astype(float)
    if kind in ("poisson", "negbin"):
        return rng.poisson(np.exp(f + 0.5)).astype(float)
    if kind == "ordinal":
        return np.digitize(f + 0.2 * rng.standard_normal(len(f)), [-0.5, 0.0, 0.5]).astype(float)
    raise ValueError(kind)


LIKS = {"gauss": lambda lib: lib.GaussianLik(), "studentt": lambda lib: lib.StudentTLik(),
        "bernoulli": lambda lib: lib.BernoulliLik(), "poisson": lambda lib: lib.PoissonLik(),
        "negbin": lambda lib: lib.NegBinomialLik(), "ordinal": lambda lib: lib.OrdinalLik(4)}
Z = np.linspace(0.2, 5.8, 5).reshape(-1, 1)


def _q_params(params, seed=1):
    """``params`` with a q off the prior (so the KL and the heads matter)."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for k, v in params.items():
        if k.endswith("_qm") or k.endswith("_ql"):
            out[k] = 0.2 * rng.standard_normal(np.shape(v))
    return out


def _logp_dlogp(proc, params):
    """``logp`` and ``dlogp``; the JAX package's from one compile."""
    if type(proc).__module__.startswith("g3py_tpu_torch"):
        return proc.logp(params), proc.dlogp(params)
    return jax_logp_dlogp(proc, params)


def _stats(proc, params, xq, y_q, kind):
    """The likelihood-dependent statistics of every family; the latent ones
    (shared by all) for two of them (most of the cost is the JAX side's
    compiles)."""
    logp, dlogp = _logp_dlogp(proc, params)
    out = {"logp": logp, "dlogp": dlogp, "mean": proc.mean(params, xq),
           "var_noise": proc.variance(params, xq, noise=True),
           "logpred": proc.logpredictive(params, xq, vector=y_q),
           "sampler": proc.sampler(params, xq, samples=4, noise=kind != "ordinal",
                                   rng=np.random.default_rng(5))}
    if kind in ("gauss", "bernoulli"):
        out.update(location=proc.location(params, xq), kernel_diag=proc.kernel_diag(params, xq),
                   var=proc.variance(params, xq), prior_mean=proc.mean(params, xq, prior=True),
                   cov=proc.covariance(params, xq),
                   quantile=proc.quantiler(params, xq, q=0.9, noise=True))
    if kind in ("bernoulli", "ordinal"):
        out["proba"] = proc.predict_proba(params, xq)
        out["class"] = proc.predict_class(params, xq)
    if kind in ("gauss", "studentt"):  # median == mean for a symmetric conditional
        out["median"] = proc.median(params, xq)
    return out


@pytest.mark.parametrize("kind", sorted(LIKS))
def test_svp_matches_jax(kind):
    x, f, xq, rng = _data()
    y = _targets(kind, f, rng)

    def build(lib):
        return lib.SVP(space=xq, location=lib.Bias(), kernel=lib.SE(x),
                       likelihood=LIKS[kind](lib), inducing=Z, name="SV" + kind)

    with floatx("float64"):
        jp, tp = process_pair(build, x, y)
        assert [p.name for p in tp.active.ordered_params] == \
            [p.name for p in jp.active.ordered_params]
        params = _q_params(nudged(jp.params_default))
        want = _stats(jp, params, xq, y[:len(xq)], kind)
        got = _stats(tp, params, xq, y[:len(xq)], kind)
    for k in want:
        assert_close(got[k], want[k], "float64", err_msg=f"{kind} {k}")
    if kind == "bernoulli":
        with pytest.raises(ValueError, match="additive-noise"):
            tp.covariance(params, xq, noise=True)
    assert (tp.th_median() is None) == (kind in ("bernoulli", "poisson", "negbin", "ordinal"))


def _heads_data(kind):
    rng = np.random.default_rng(7)
    if kind == "multiclass":
        x = rng.standard_normal((40, 2))
        y = np.digitize(x[:, 0] + 0.3 * x[:, 1], [-0.5, 0.5]).astype(float)
        return x, y, rng.standard_normal((5, 2)), x[::8][:5] + 0.01
    x = np.sort(rng.uniform(0, 6, 40)).reshape(-1, 1)
    y = np.sin(x[:, 0]) + (0.05 + 0.1 * x[:, 0]) * rng.standard_normal(40)
    return x, y, np.linspace(0.2, 5.8, 5).reshape(-1, 1), Z


@pytest.mark.parametrize("kind", ["multiclass", "heteroscedastic"])
def test_multihead_matches_jax(kind):
    x, y, xq, z = _heads_data(kind)

    def build(lib):
        if kind == "multiclass":
            return lib.MulticlassSVP(space=xq, kernel=lib.SE(x), classes=3, inducing=z,
                                     name="MH" + kind)
        return lib.HeteroscedasticSVP(space=xq, location=lib.Bias(), kernel=lib.SE(x),
                                      inducing=z, name="MH" + kind)

    with floatx("float64"):
        jp, tp = process_pair(build, x, y)
        params = _q_params(nudged(jp.params_default), seed=2)
        out = []
        for p in (jp, tp):
            logp, dlogp = _logp_dlogp(p, params)
            o = {"logp": logp, "dlogp": dlogp,
                 "location": p.location(params, xq), "kernel_diag": p.kernel_diag(params, xq),
                 "prior_location": p.location(params, xq, prior=True),
                 "mean": p.mean(params, xq), "var_noise": p.variance(params, xq, noise=True),
                 "var": p.variance(params, xq),
                 "logpred": p.logpredictive(params, xq, vector=y[:len(xq)]),
                 "cov": p.covariance(params, xq, noise=kind != "multiclass"),
                 "prior_cov": p.covariance(params, xq, prior=True),
                 "sampler": p.sampler(params, xq, samples=3, noise=True,
                                      rng=np.random.default_rng(4)),
                 "quantile": p.quantiler(params, xq, q=0.8)}
            if kind == "multiclass":
                o["proba"] = p.predict_proba(params, xq)
                o["scores"] = dict(p.scores(params, xq, hidden=y[:len(xq)], logp=True,
                                            logpred=True, variance=True))
            else:
                o["noise_field"] = p.noise_field(params, xq)
                o["median"] = p.median(params, xq)
            out.append(o)
    want, got = out
    for k in want:
        assert_close(got[k], want[k], "float64", err_msg=f"{kind} {k}")


def test_fit_svgp_minibatch_matches_jax():
    """Adam over the hypers and q, the JAX package's ``randint`` draws
    injected: the loss trajectory at 1e-8; the full batch likewise."""
    x, f, _, rng = _data(n=30)
    y = _targets("studentt", f, rng)
    steps, bs = 12, 10

    def build(lib):
        return lib.SVP(space=x[:4], location=lib.Bias(), kernel=lib.SE(x),
                       likelihood=lib.StudentTLik(), inducing=Z, name="SVfit")

    with floatx("float64"):  # the draws of x64 mode (int64 indices)
        keys = random.split(random.PRNGKey(3), steps)
        idx = np.stack([np.asarray(random.randint(k, (bs,), 0, len(x))) for k in keys])
        jp, tp = process_pair(build, x, y)
        for batch, key in ((bs, idx), (100, 0)):
            _, lj = jp.fit_svgp(batch_size=batch, steps=steps, lr=0.02, key=3, display=False)
            _, lt = tp.fit_svgp(batch_size=batch, steps=steps, lr=0.02, key=key,
                                display=False)
            np.testing.assert_allclose(lt, np.asarray(lj), rtol=1e-8, err_msg=str(batch))
    with pytest.raises(NotImplementedError, match="item 16"):
        tp.fit_svgp(steps=2, mesh=2)


def test_predictor_and_params_only_export(tmp_path):
    """The SVP predictor carries the params and the inducing gram's factor
    (m, m) only; its statistics equal the process's, and the exported
    artifact serves them with no model code; quantiles need the latent hook
    the family lacks, as in the JAX package."""
    x, f, xq, rng = _data()
    y = _targets("gauss", f, rng)
    with floatx("float64"):
        jp, tp = process_pair(lambda lib: lib.SVP(space=xq, location=lib.Bias(),
                                                  kernel=lib.SE(x), inducing=Z, name="SVpr"),
                              x, y)
        params = _q_params(nudged(jp.params_default))
        jpr = jp.predictor(params)
        tpr = tp.predictor(g3t.params_from_jax(tp, params))
        assert {v.shape for v in tpr.state.values()} == {(5, 5)}
        want = jpr(xq, mean=True, std=True, var=True, noise=True)
        got = tpr(xq, mean=True, std=True, var=True, noise=True)
        assert_close(dict(got), {k: np.asarray(v) for k, v in want.items()}, "float64")
        with pytest.raises(ValueError, match="_quantile_p"):
            tpr(xq, quantiles=True)
        path = tpr.export(str(tmp_path / "svp"), mean=True, std=True, noise=True)
        loaded = g3t.load_predictor(path)
        out = loaded(xq)
        np.testing.assert_allclose(out["mean"].numpy(), got["mean"], rtol=1e-12)
        np.testing.assert_allclose(out["std"].numpy(), got["std"], rtol=1e-12)
        data = np.load(os.path.join(path, "state.npz"))
        assert max(data[k].size for k in data.files if k.startswith("merged/")) == 25


ROW_FAMILIES = {
    "gauss": lambda lib, x: lib.SVP(space=x[:4], location=lib.Bias(), kernel=lib.SE(x),
                                    likelihood=lib.GaussianLik(), inducing=Z, name="RW_g"),
    "studentt": lambda lib, x: lib.SVP(space=x[:4], location=lib.Bias(), kernel=lib.SE(x),
                                       likelihood=lib.StudentTLik(), inducing=Z, name="RW_t"),
    "ordinal": lambda lib, x: lib.SVP(space=x[:4], location=lib.Bias(), kernel=lib.SE(x),
                                      likelihood=lib.OrdinalLik(4), inducing=Z, name="RW_o"),
    "multiclass": lambda lib, x: lib.MulticlassSVP(space=x[:4], kernel=lib.SE(x), classes=3,
                                                   inducing=Z, name="RW_c"),
    "heteroscedastic": lambda lib, x: lib.HeteroscedasticSVP(
        space=x[:4], location=lib.Bias(), kernel=lib.SE(x), inducing=Z, name="RW_h"),
}


@pytest.mark.parametrize("family", sorted(ROW_FAMILIES))
def test_svp_rows_are_one_batched_call(family, monkeypatch):
    """A (R, ndim) matrix of rows: one K1 pair (Kuu, Kuf) and one K2 call
    (the plain versions' call counters), each row's logp, gradient, mean
    and log predictive equal to its own (float64, 1e-10), and equal to the
    JAX package's ``vmap`` over the rows."""
    from torch_parity import KernelSpy

    x, f, xq, rng = _data()
    kind = {"multiclass": "ordinal", "heteroscedastic": "gauss"}.get(family, family)
    y = _targets(kind, f, rng)
    if family == "multiclass":
        y = np.minimum(y, 2.0)
    with floatx("float64"):
        jp, tp = process_pair(lambda lib: ROW_FAMILIES[family](lib, x), x, y)
        u = tp.active.dict_to_array(_q_params(nudged(jp.params_default)))
        rows = u[None, :] + 0.05 * np.random.default_rng(2).standard_normal((5, len(u)))
        spy = KernelSpy(monkeypatch)
        got = tp.logp_chain(rows)
        assert spy.take() == (2, 1)
        _, grad = tp._rows_value_and_grad(rows)
        assert spy.take() == (2, 1)
        np.testing.assert_allclose(got, [tp.logp(r, array=True) for r in rows], rtol=1e-10)
        np.testing.assert_allclose(grad.numpy(), np.stack([tp.dlogp(r) for r in rows]),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got, np.asarray(jp.logp_chain(rows)), rtol=1e-10)
        reg = tp.active
        p = reg.array_to_dict_tensor(torch.as_tensor(rows))
        space, inputs, outputs = tp._resolve_data(xq, None, None)
        vector = torch.as_tensor(y[:len(xq)])
        spy.take()
        mean = tp.th_mean()(p, space, inputs, outputs, vector)
        logpred = tp.th_logpredictive()(p, space, inputs, outputs, vector)
        assert spy.take() == (4, 2)
        for r, row in enumerate(rows):
            one = reg.array_to_dict(row)
            assert_close(mean[r], tp.mean(one, xq), "float64")
            assert_close(logpred[r], tp.logpredictive(one, xq, vector=y[:len(xq)]), "float64")
