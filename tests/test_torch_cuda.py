"""Card-only checks of the port: the CUDA kernels (stationary gram, panel
Cholesky) against their plain PyTorch versions, and the GP/WGP serving and
training paths on the card against the same paths on the CPU.

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
    assert stationary_gram.launches >= launches + 4  # logp, state, cross, query grams
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
