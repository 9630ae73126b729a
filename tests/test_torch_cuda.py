"""Card-only checks of the port: the CUDA kernels (stationary gram, panel
Cholesky) against their plain PyTorch versions, the GP/WGP serving and
training paths, the Bayesian path and the Student-t, transport and copula
families on the card against the same paths on the CPU, and ``betainc``.

These skip where ``torch.cuda.is_available()`` is False.  The file imports
neither JAX nor g3py_tpu, so it runs on a machine that has only PyTorch:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
from g3py_tpu_torch.ops.panel_cholesky import _plain_form as _k2_plain, panel_cholesky
from g3py_tpu_torch.ops.stationary_gram import KINDS, _plain_form, stationary_gram

RAGGED = [(13, 7, 3), (5, 11, 1), (9, 9, 6), (300, 200, 8), (65, 129, 37)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    old = g3t.settings.device
    yield torch.device("cuda")
    g3t.settings.device = old


def _inputs(seed, m, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)), rng.standard_normal((n, d)),
            rng.uniform(0.3, 1.2, d), np.array(1.7), np.array(0.8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 2e-6),
                                             (torch.float64, 1e-12, 1e-14)])
def test_kernel_matches_plain_form(cuda, dtype, rtol, atol):
    launches = stationary_gram.launches
    for i, shape in enumerate(RAGGED):
        ins = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in _inputs(i, *shape)]
        for kind in sorted(KINDS):
            out = stationary_gram(kind, *ins)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, _plain_form(kind, *ins), rtol=rtol, atol=atol)
    assert stationary_gram.launches == launches + len(RAGGED) * len(KINDS)


def _golden(kind, device):
    g3t.settings.device = device
    rng = np.random.default_rng(1234)
    x = np.linspace(0, 10, 32).astype(np.float32).reshape(-1, 1)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(32)).astype(np.float32)
    if kind == "gp":
        proc = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="CUDA_GP")
    else:
        y = (np.exp(0.3 * y) + 1.0).astype(np.float32)
        proc = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.MAT52(x),
                       mapping=g3t.BoxCoxLinear(y), name="CUDA_WGP")
    proc.observed(x, y)
    xq = np.linspace(-1.0, 11.0, 40).astype(np.float32).reshape(-1, 1)
    out = proc.predictor()(xq, mean=True, std=True, quantiles=True, quantiles_noise=True)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["logp"] = np.asarray(proc.logp())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_serving_on_card_matches_cpu(cuda, kind):
    want = _golden(kind, "cpu")
    launches = stationary_gram.launches
    got = _golden(kind, "cuda")
    # logp, state, cross gram; the query gram's diagonal is K1's amplitude
    assert stationary_gram.launches >= launches + 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def _spd(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T / n + np.eye(n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("n,block", [(1, 128), (77, 64), (200, 128), (257, 64), (640, 128),
                                     (256, 128), (384, 128), (385, 128), (1000, 128)])
def test_panel_cholesky_matches_plain_form(cuda, dtype, tol, n, block):
    a = torch.as_tensor(_spd(n, n), dtype=dtype, device=cuda)
    launches = panel_cholesky.launches
    l, dinv, info = panel_cholesky(a, block)
    torch.cuda.synchronize()
    assert panel_cholesky.launches == launches + 1
    lp, dinv_p, info_p = _k2_plain(a, block)
    assert int(info) == int(info_p) == 0
    torch.testing.assert_close(l, lp, rtol=tol, atol=tol)
    torch.testing.assert_close(dinv, dinv_p, rtol=tol, atol=tol)
    assert float(torch.triu(l, 1).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_panel_cholesky_info(cuda, dtype):
    a = torch.as_tensor(_spd(3, 300), dtype=dtype, device=cuda)
    for j in (0, 5, 130, 150, 299):  # 150: the second 16-column leaf of a tile
        bad = a.clone()
        bad[j, :] = 0.0
        bad[:, j] = 0.0
        bad[j, j] = -1.0
        assert int(panel_cholesky(bad)[2]) == int(torch.linalg.cholesky_ex(bad)[1]) == j + 1
    bad = a.clone()
    bad[40, 2] = bad[2, 40] = float("nan")
    assert int(panel_cholesky(bad)[2]) > 0


def _trained(kind, device):
    g3t.settings.device = device
    g3t.settings.floatx = "float64"
    try:
        rng = np.random.default_rng(1234)
        x = np.linspace(0, 10, 32).reshape(-1, 1)
        y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(32)
        if kind == "gp":
            proc = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="CT_GP")
        else:
            y = np.exp(0.3 * y) + 1.0
            proc = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.MAT52(x),
                           mapping=g3t.BoxCoxLinear(y), name="CT_WGP")
        proc.observed(x, y)
        dlogp = proc.dlogp()
        params = proc.find_MAP(points=2, display=False)
        return dlogp, proc.logp(params)
    finally:
        g3t.settings.floatx = "float32"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gp", "wgp"])
def test_training_on_card_matches_cpu(cuda, kind):
    want = _trained(kind, "cpu")
    k1, k2 = stationary_gram.launches, panel_cholesky.launches
    got = _trained(kind, "cuda")
    assert stationary_gram.launches > k1 and panel_cholesky.launches > k2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


# ---------------------------------------------------------------- batched kernels
BATCH_SHAPES = [(1, 13, 7, 3), (4, 125, 125, 8), (3, 300, 200, 8), (2, 65, 129, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 2e-6),
                                             (torch.float64, 1e-12, 1e-14)])
def test_batched_gram_matches_plain_form(cuda, dtype, rtol, atol):
    """One launch for R rows of (rate, var, alpha); each row as its own gram."""
    for i, (rows, m, n, d) in enumerate(BATCH_SHAPES):
        rng = np.random.default_rng(100 + i)
        x1, x2 = (torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=cuda)
                  for s in ((m, d), (n, d)))
        rate, var, alpha = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (
            rng.uniform(0.3, 1.2, (rows, d)), rng.uniform(0.5, 2.0, rows),
            rng.uniform(0.5, 2.0, rows)))
        for kind in sorted(KINDS):
            extra = alpha if kind == "rq" else None
            launches = stationary_gram.launches
            out = stationary_gram(kind, x1, x2, rate, var, extra)
            torch.cuda.synchronize()
            assert stationary_gram.launches == launches + 1
            assert out.shape == (rows, m, n)
            torch.testing.assert_close(out, _plain_form(kind, x1, x2, rate, var, extra),
                                       rtol=rtol, atol=atol)
            for r in range(rows):
                single = stationary_gram(kind, x1, x2, rate[r], var[r],
                                         None if extra is None else extra[r])
                torch.testing.assert_close(out[r], single, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("rows,n,block", [(1, 200, 128), (3, 77, 64), (4, 257, 64),
                                          (3, 385, 128), (2, 640, 128)])
def test_batched_panel_cholesky_matches_plain_form(cuda, dtype, tol, rows, n, block):
    a = torch.stack([torch.as_tensor(_spd(n + r, n), dtype=dtype, device=cuda)
                     for r in range(rows)])
    launches = panel_cholesky.launches
    l, dinv, info = panel_cholesky(a, block)
    torch.cuda.synchronize()
    assert panel_cholesky.launches == launches + 1
    assert l.shape == (rows, n, n) and info.shape == (rows,)
    lp, dinv_p, info_p = _k2_plain(a, block)
    assert info.tolist() == info_p.tolist() == [0] * rows
    torch.testing.assert_close(l, lp, rtol=tol, atol=tol)
    torch.testing.assert_close(dinv, dinv_p, rtol=tol, atol=tol)
    for r in range(rows):
        one = panel_cholesky(a[r], block)
        torch.testing.assert_close(l[r], one[0], rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,block", [(torch.float32, 128), (torch.float64, 64),
                                         (torch.float64, 128)])
def test_batched_panel_cholesky_one_failing_row(cuda, dtype, block):
    """Only the row with the negative pivot reports it; the others factor
    as they do alone."""
    rows, n, j = 4, 300, 150
    a = torch.stack([torch.as_tensor(_spd(7 + r, n), dtype=dtype, device=cuda)
                     for r in range(rows)])
    a[2, j, :] = 0.0
    a[2, :, j] = 0.0
    a[2, j, j] = -1.0
    l, _, info = panel_cholesky(a, block)
    torch.cuda.synchronize()
    assert info.tolist() == [0, 0, j + 1, 0]
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    for r in (0, 1, 3):
        torch.testing.assert_close(l[r], panel_cholesky(a[r], block)[0], rtol=tol, atol=tol)


def _bayes_pair(device, floatx="float64"):
    g3t.settings.device = device
    g3t.settings.floatx = floatx
    rng = np.random.default_rng(8)
    x = rng.standard_normal((40, 2))
    y = np.exp(0.3 * np.sin(x[:, 0]) + 0.05 * rng.standard_normal(40)) + 1.0
    proc = g3t.WGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x),
                   mapping=g3t.BoxCoxLinear(y), name=f"CB_{device}")
    proc.observed(x, y)
    u0 = proc.active.dict_to_array(proc.params_default)
    rows = u0 + 0.2 * np.random.default_rng(9).standard_normal((6, len(u0)))
    return proc, rows


@pytest.mark.cuda
def test_bayesian_path_on_card_matches_cpu(cuda):
    """logp_chain and the averaged predictor of six rows, in float64: one
    batched K1 and K2 launch on the card against the plain versions on the
    CPU."""
    try:
        want_proc, rows = _bayes_pair("cpu")
        want_ll = want_proc.logp_chain(rows)
        xq = np.linspace(-2, 2, 9).reshape(-1, 1).repeat(2, axis=1)
        want = want_proc.averaged_predictor(rows)(xq, quantiles=True)
        proc, _ = _bayes_pair("cuda")
        k1, k2 = stationary_gram.launches, panel_cholesky.launches
        got_ll = proc.logp_chain(rows)
        assert (stationary_gram.launches, panel_cholesky.launches) == (k1 + 1, k2 + 1)
        got = proc.averaged_predictor(rows)(xq, quantiles=True)
    finally:
        g3t.settings.floatx = "float32"
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-9)
    for k in want:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


# ---------------------------------------------------------------- process families
def _family(kind, device):
    """logp, dlogp and a statistic of a Student-t, transport or copula
    process in float64 on ``device``."""
    g3t.settings.device = device
    g3t.settings.floatx = "float64"
    try:
        rng = np.random.default_rng(21)
        x = np.linspace(0, 10, 48).reshape(-1, 1)
        y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(48)
        if kind == "tp":
            proc = g3t.TP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="CF_TP")
        elif kind == "tgp":
            proc = g3t.TGP(space=x, transport=g3t.TLocation(g3t.Bias(x))
                           @ g3t.TKernel(g3t.SE(x), noisy=True), name="CF_TGP")
        else:
            y = np.exp(0.3 * y) + 1.0
            proc = g3t.CGP(space=x, kernel=g3t.SE(x), marginal=g3t.Normal(
                mu=g3t.Bias(x, name="M"), sigma=g3t.Bias(x, name="S")), name="CF_CGP")
        proc.observed(x, y)
        xq = np.linspace(-1, 11, 17).reshape(-1, 1)
        if kind == "tgp":
            stat = proc.sampler(space=xq, samples=5, rng=np.random.default_rng(3))
        else:
            stat = proc.quantiler(space=xq)
        return proc.logp(), proc.dlogp(), stat.cpu().numpy()
    finally:
        g3t.settings.floatx = "float32"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tp", "tgp", "cgp"])
def test_family_on_card_matches_cpu(cuda, kind):
    """TP, TGP and CGP logp/dlogp (and quantiles or draws) on the card, through
    K1 and K2, against the CPU float64 port."""
    want = _family(kind, "cpu")
    k1, k2 = stationary_gram.launches, panel_cholesky.launches
    got = _family(kind, "cuda")
    assert stationary_gram.launches > k1 and panel_cholesky.launches > k2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_betainc_on_card_matches_cpu(cuda, dtype, rtol):
    from g3py_tpu_torch.ops.special import betainc

    rng = np.random.default_rng(5)
    a, b, x = rng.uniform(0.1, 40.0, 500), rng.uniform(0.1, 6.0, 500), rng.uniform(0, 1, 500)
    want = betainc(*[torch.as_tensor(v, dtype=dtype) for v in (a, b, x)])
    got = betainc(*[torch.as_tensor(v, dtype=dtype, device=cuda) for v in (a, b, x)])
    torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=rtol)


# ---------------------------------------------------------------- the catalogue
def _algebra_inputs(device, dtype, seed=31):
    rng = np.random.default_rng(seed)
    x1 = torch.as_tensor(rng.standard_normal((300, 8)), dtype=dtype, device=device)
    x2 = torch.as_tensor(rng.standard_normal((129, 8)), dtype=dtype, device=device)
    rates = torch.as_tensor(rng.uniform(0.3, 1.2, (5, 8)), dtype=dtype, device=device)
    return x1, x2, rates


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 2e-6),
                                             (torch.float64, 1e-12, 1e-14)])
def test_kernel_on_algebra_inputs_matches_plain_form(cuda, dtype, rtol, atol):
    """K1 on the inputs the kernel algebra reaches: a dims-restricted slice
    (d=1 of 8), one Param rate shared by two factors, and a 0-d amplitude
    (a product's pinned 1) beside a rate of R rows."""
    g3t.settings.device = "cuda"
    old = g3t.settings.floatx
    g3t.settings.floatx = "float64" if dtype == torch.float64 else "float32"
    try:
        x1, x2, rates = _algebra_inputs(cuda, dtype)
        shared = g3t.Param("C_shared_rate", shape=(8,), prior=g3t.FlatExp())
        k = (g3t.SE([3], name="SEd")
             + g3t.SE(8, name="SEa", metric=g3t.ARD_L2(8, rate=shared))
             * g3t.MAT52(8, name="Ma", metric=g3t.ARD_L2(8, rate=shared)))
        k.check_hypers("C_")
        # the product pins MAT52's amplitude to a 0-d 1
        assert k.k2.k2.var == 1.0
        params = {"C_SEd_var": torch.tensor(1.3, dtype=dtype, device=cuda),
                  "C_SEd_rate": rates[0, :1],
                  "C_SEa_var": torch.tensor(0.7, dtype=dtype, device=cuda),
                  "C_shared_rate": rates[1]}
        launches = stationary_gram.launches
        got = k.cov(params, x1, x2)
        torch.cuda.synchronize()
        assert stationary_gram.launches == launches + 3
        want = (_plain_form("se", x1[:, [3]], x2[:, [3]], rates[0, :1], params["C_SEd_var"])
                + _plain_form("se", x1, x2, rates[1], params["C_SEa_var"])
                * _plain_form("mat52", x1, x2, rates[1], torch.ones((), dtype=dtype,
                                                                     device=cuda)))
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        one = torch.tensor(1.0, dtype=dtype, device=cuda)
        for kind in sorted(KINDS):
            alpha = torch.tensor(0.8, dtype=dtype, device=cuda)
            rows = stationary_gram(kind, x1, x2, rates, one, alpha)
            torch.testing.assert_close(rows, _plain_form(kind, x1, x2, rates, one.expand(5),
                                                         alpha.expand(5)),
                                       rtol=rtol, atol=atol)
    finally:
        g3t.settings.floatx = old


def _composite(device, dtype="float64"):
    """GP(Linear + Bias, SE * SIN + 2 MAT52 + LIN + 0.1): logp, dlogp,
    logp_chain of four rows and predict's mean and std on ``device``."""
    g3t.settings.device = device
    g3t.settings.floatx = dtype
    try:
        rng = np.random.default_rng(32)
        x = rng.standard_normal((96, 3))
        y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(96)
        gp = g3t.GP(space=x[:5], location=g3t.Linear(x) + g3t.Bias(),
                    kernel=g3t.SE(x) * g3t.SIN(x) + 2.0 * g3t.MAT52(x) + g3t.LIN(x) + 0.1,
                    name="CC_GP")
        gp.observed(x, y)
        u = gp.active.dict_to_array(gp.params_default)
        rows = u[None, :] + 0.05 * np.random.default_rng(33).standard_normal((4, len(u)))
        pred = gp.predict(gp.params_default, x[:17], mean=True, std=True)
        return (gp.logp(), gp.dlogp(), gp.logp_chain(rows),
                {k: v.cpu().numpy() for k, v in pred.items()})
    finally:
        g3t.settings.floatx = "float32"


@pytest.mark.cuda
def test_composite_gp_on_card_matches_cpu(cuda):
    """The phase 9a composite in float64: two K1 launches (SE, MAT52) per
    gram, one batched K1 a factor and one K2 for four rows, against the CPU
    port."""
    want = _composite("cpu")
    k1, k2 = stationary_gram.launches, panel_cholesky.launches
    got = _composite("cuda")
    assert stationary_gram.launches > k1 and panel_cholesky.launches > k2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9)
    for k in want[3]:
        np.testing.assert_allclose(got[3][k], want[3][k], rtol=1e-9, atol=1e-12, err_msg=k)


# ---------------------------------------------------------------- serving and toolbox
def _toolbox(device, tmp):
    """Every path of the streaming/pathwise/export/rows/fix_vars slice on
    ``device`` in float64, on the same data, draws and rows."""
    g3t.settings.device = device
    g3t.settings.floatx = "float64"
    try:
        rng = np.random.default_rng(31)
        x = rng.standard_normal((60, 2))
        y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(60)
        xq = rng.standard_normal((9, 2))
        gp = g3t.GP(space=xq, location=g3t.Bias(), kernel=g3t.SE(x), name="CT_GP")
        gp.observed(x[:52], y[:52])
        params = gp.params_default
        out = {}
        pr = gp.predictor(params)
        draws = {"parts": [{k: np.random.default_rng(i).standard_normal(s)
                            for i, (k, s) in enumerate((("z", (64, 2)), ("b", (64,)),
                                                        ("theta", (64, 3))))}],
                 "eps": np.random.default_rng(9).standard_normal((52, 3))}
        out["pathwise"] = pr.pathwise_sampler(space=xq, samples=3, key=draws, n_features=64)
        out["updated"] = pr.updated(x[52:], y[52:])(xq, quantiles=True)["quantile_up"]
        path = pr.__class__(gp, params).export(str(tmp / device), quantiles=True)
        out["exported"] = g3t.load_predictor(path)(xq)["quantile_down"]
        u0 = gp.active.dict_to_array(params)
        rows = u0 + 0.05 * rng.standard_normal((4, len(u0)))
        out["batch_sample"] = gp.batch_sample(rows, rng=np.random.default_rng(2))
        cols = {c: rows[:, i] for i, c in enumerate(gp.active.param_names())}
        gp.active.fix_vars(g3t.Datatrace(cols), ["CT_GP_SE_rate__0"])
        sp = gp.active.sampling_params(u0)
        out["fixed_logp"] = gp.fixed_logp(sp, return_array=True)
        out["fixed_dlogp"] = gp.fixed_dlogp(sp, return_array=True)
        gp.active.fix_vars()
        shear, _ = gp._noncentered_sampling_shear()
        out["shear"] = shear(torch.as_tensor(rows, device=device))
        return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
    finally:
        g3t.settings.floatx = "float32"


@pytest.mark.cuda
def test_toolbox_on_card_matches_cpu(cuda, tmp_path):
    """Pathwise draws, the streaming update, an exported and reloaded
    predictor, draws over rows, the fixed-chain logps and gradients and the
    non-centered shear, on the card (through K1 and K2, the artifact's K1 as
    the registered operator) against the CPU float64 port."""
    want = _toolbox("cpu", tmp_path)
    k1 = stationary_gram.launches
    got = _toolbox("cuda", tmp_path)
    assert stationary_gram.launches > k1
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-10, err_msg=k)


@pytest.mark.cuda
def test_cpu_artifact_served_on_card(cuda, tmp_path):
    """An artifact exported on the CPU loads onto the card (the program is
    moved there) and calls K1 once a query batch."""
    g3t.settings.device = "cpu"
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), name="CT_EX")
    gp.observed(x, y)
    pr = gp.predictor()
    path = pr.export(str(tmp_path / "cpu"), quantiles=True)
    want = pr(x[:7], quantiles=True)
    ep = g3t.load_predictor(path, device="cuda")
    k1 = stationary_gram.launches
    got = ep(x[:7])
    assert stationary_gram.launches == k1 + 1
    for k in want:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_batched_mvn_backward_on_card_matches_cpu(cuda, dtype, rtol):
    """The batched analytic backward of mvn_quad_logdet: one batched K2
    launch on the card against the plain form on the CPU."""
    from g3py_tpu_torch.ops.linalg import mvn_quad_logdet

    rng = np.random.default_rng(8)
    a = rng.standard_normal((5, 130, 130))
    k = a @ a.transpose(0, 2, 1) + 130 * np.eye(130)
    r = rng.standard_normal((5, 130))
    grads = {}
    for device in ("cpu", "cuda"):
        kt = torch.tensor(k, dtype=dtype, device=device, requires_grad=True)
        rt = torch.tensor(r, dtype=dtype, device=device, requires_grad=True)
        k2 = panel_cholesky.launches
        quad, logdet, _ = mvn_quad_logdet(kt, rt)
        (quad.sum() + 2 * logdet.sum()).backward()
        if device == "cuda":
            assert panel_cholesky.launches == k2 + 1
        grads[device] = (kt.grad.cpu(), rt.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * 1e-2)
