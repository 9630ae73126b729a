"""Port parity of the kernel zoo, periodic, noise and index kernels: COS,
SIN, SINC and SM (one feature slab at a time), WN and KernelNoise of
tests/test_zoo.py's ``KERNELS``, KernelMax (a tie on its diagonal) and the
index kernels KernelEquals / KernelEquals2 on an index column, each in a
GP: logp, ``dlogp`` (against ``jax.grad``) and predict's mean and std
against the JAX package in float64 (JAX x64) at 1e-10; and the periodic
kernels over R parameter rows against the rows one at a time, with no
N x M x d tensor."""

import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
from torch_parity import check_gp, floatx, zoo_data

PERIODIC = ["COS", "SIN", "SINC", "SM"]


@pytest.mark.parametrize("kname", PERIODIC + ["WN", "KernelNoise"])
def test_kernel_in_gp_matches_jax_float64(kname):
    x = zoo_data()[0]
    check_gp(kname, lambda lib: getattr(lib, kname)(x))


def test_kernel_max_tie_matches_jax_float64():
    # SE and OU default to one amplitude, var(y): their grams tie on the
    # diagonal, where each side takes half the gradient
    x = zoo_data()[0]
    check_gp("KMax", lambda lib: lib.KernelMax(lib.SE(x), lib.OU(x)))


def _index_data(seed=3, n=16):
    """An index column of 0, 1, 2 beside a continuous one (zoo_data's
    shapes, whose JAX ops are already warm)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 3, n).astype(float)
    t = rng.uniform(0.0, 5.0, n)
    x = np.stack([idx, t], axis=1)
    y = np.sin(t) + 0.5 * idx + 0.1 * rng.standard_normal(n)
    xq = np.stack([np.arange(7) % 3, np.linspace(0.5, 4.5, 7)], axis=1).astype(float)
    return x, y, xq


@pytest.mark.parametrize("index", ["Equals", "Equals2"])
def test_index_kernels_match_jax_float64(index):
    data = _index_data()
    x = data[0]

    def kernel(lib):
        gate = (lib.KernelEquals([0], eq=1) if index == "Equals"
                else lib.KernelEquals2([0], eq1=0, eq2=2))
        return gate * lib.SE([1], name="SEt") + lib.SE(x)

    check_gp("K" + index, kernel, data=data)


@pytest.mark.parametrize("kname", PERIODIC)
def test_periodic_rows_match_single_rows(kname):
    x, y, xq = zoo_data(n=12, d=3, seed=4)
    with floatx("float64"), torch.no_grad():
        gp = g3t.GP(space=x, location=g3t.Bias(), kernel=getattr(g3t, kname)(x),
                    name="TPR" + kname)
        gp.observed(x, y)
        reg = gp.active
        u = reg.dict_to_array(gp.params_default)
        rows = u[None, :] + 0.1 * np.random.default_rng(5).standard_normal((4, len(u)))
        prow = reg.array_to_dict_tensor(torch.as_tensor(rows))
        xt, xqt = torch.as_tensor(x), torch.as_tensor(xq)
        batched = gp.f_kernel.cov(prow, xqt, xt)
        assert batched.shape == (4, len(xq), len(x))
        for r in range(len(rows)):
            one = gp.f_kernel.cov({k: v[r] for k, v in prow.items()}, xqt, xt)
            np.testing.assert_allclose(batched[r].numpy(), one.numpy(), rtol=1e-13)
        np.testing.assert_allclose(gp.logp_chain(rows), [gp.logp(r, array=True) for r in rows],
                                   rtol=1e-12)
