"""Port parity of the kernel zoo, stationary and dot families: every kernel
of tests/test_zoo.py's ``KERNELS`` but the periodic and noise ones (in
tests/test_torch_zoo_periodic.py) in a GP, logp, ``dlogp`` (against
``jax.grad``) and predict's mean and std against the JAX package in float64
(JAX x64) at 1e-10, with the defaults bit for bit and the cross
covariances; and that OU (exp on ARD_L1) and an SE on a fixed rate take
the generic path, not the fused gram K1 (tests/torch_parity.py's spy
counts the wrappers' calls)."""

import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
from torch_parity import KernelSpy, assert_close, check_gp, floatx, jax_eager, zoo_data

# tests/test_zoo.py KERNELS but the periodic and noise ones
KERNELS = ["SE", "OU", "RQ", "MAT32", "MAT52", "BW", "VAR", "NIL", "LIN", "POL", "NN"]


@pytest.mark.parametrize("kname", KERNELS)
def test_kernel_in_gp_matches_jax_float64(kname):
    x, _, xq = zoo_data()
    jp, tp, params = check_gp(kname, lambda lib: getattr(lib, kname)(x))
    with floatx("float64"), jax_eager():
        tparams = {k: torch.as_tensor(v) for k, v in params.items()}
        assert_close(tp.f_kernel.cov(tparams, torch.as_tensor(xq), torch.as_tensor(x)),
                     np.asarray(jp.f_kernel.cov(params, xq, x)), "float64")


@pytest.mark.parametrize("kname", ["OU", "fixed"])
def test_generic_path_takes_no_k1(monkeypatch, kname):
    spy = KernelSpy(monkeypatch)
    x, y, _ = zoo_data()
    rate = np.full(2, 0.7)
    kernel = (g3t.OU(x) if kname == "OU"
              else g3t.SE(x, metric=g3t.ARD_L2(x, rate=rate)))
    gp = g3t.GP(space=x, location=g3t.Bias(), kernel=kernel, name="TZG" + kname)
    gp.observed(x, y)
    assert gp.f_kernel._gram_dispatchable() is None
    spy.take()
    gp.logp()
    assert spy.take() == (0, 1)
