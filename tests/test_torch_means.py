"""Port parity of the means: Zero, Bias, Linear, Power, BlackBox and the
mean algebra (scale, shift, product, sum; tests/test_zoo.py's
``TestMeanZoo``) as the location of a GP — logp, ``dlogp`` (against
``jax.grad``) and predict's mean and std against the JAX package in
float64 (JAX x64) at 1e-10, the defaults bit for bit — and each mean over
R parameter rows against the rows one at a time."""

import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
from torch_parity import check_gp, floatx, zoo_data

LOCATIONS = {
    "Zero": lambda lib, x, y: lib.Zero(x),
    "Bias": lambda lib, x, y: lib.Bias(x),
    "Linear": lambda lib, x, y: lib.Linear(x),
    "Power": lambda lib, x, y: lib.Power(x, n=3),
    "BlackBox": lambda lib, x, y: lib.BlackBox(np.full(len(x), 1.6)),
    "Bias+0.5Linear": lambda lib, x, y: lib.Bias(x) + 0.5 * lib.Linear(x),
    "Linear*Bias+1": lambda lib, x, y: lib.Linear(x) * lib.Bias(x, name="B2") + 1.0,
    "Power*2": lambda lib, x, y: lib.Power(x) * 2.0,
}


@pytest.mark.parametrize("label", sorted(LOCATIONS))
def test_mean_in_gp_matches_jax_float64(label):
    x, y, xq = zoo_data()
    # BlackBox is a fixed array of the training length: predict at the
    # training points
    data = (x, y, x) if label == "BlackBox" else (x, y, xq)
    check_gp("M" + label.replace("+", "p").replace("*", "t").replace(".", "_"),
             lambda lib: lib.SE(x), location=lambda lib: LOCATIONS[label](lib, x, y), data=data)


@pytest.mark.parametrize("label", ["Linear", "Power", "Bias+0.5Linear", "Linear*Bias+1"])
def test_mean_rows_match_single_rows(label):
    x, y, xq = zoo_data(seed=2)
    with floatx("float64"), torch.no_grad():
        gp = g3t.GP(space=x, location=LOCATIONS[label](g3t, x, y), kernel=g3t.SE(x),
                    name="TMR" + str(len(label)))
        gp.observed(x, y)
        reg = gp.active
        u = reg.dict_to_array(gp.params_default)
        rows = u[None, :] + 0.1 * np.random.default_rng(3).standard_normal((4, len(u)))
        prow = reg.array_to_dict_tensor(torch.as_tensor(rows))
        xqt = torch.as_tensor(xq)
        batched = gp.f_location(prow, xqt)
        assert batched.shape == (4, len(xq))
        for r in range(4):
            one = gp.f_location({k: v[r] for k, v in prow.items()}, xqt)
            np.testing.assert_allclose(batched[r].numpy(), one.numpy(), rtol=1e-13)
        np.testing.assert_allclose(gp.logp_chain(rows), [gp.logp(r, array=True) for r in rows],
                                   rtol=1e-12)
