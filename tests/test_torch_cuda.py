"""Card-only checks of the port: the CUDA stationary-gram kernel against its
plain PyTorch version, and the GP/WGP serving path on the card against the
same path on the CPU.

These skip where ``torch.cuda.is_available()`` is False.  The file imports
neither JAX nor g3py_tpu, so it runs on a machine that has only PyTorch:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
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
