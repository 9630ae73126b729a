"""Port parity of ``ops/root.py::newton_inverse``: the bracketed,
bisection-safeguarded Newton solve and its implicit gradient against the
JAX package's ``lax.custom_root`` version, a stiff warping (b ~ e^15, a
near-step in float32) and a leading row axis against ``jax.vmap``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g3py_tpu.ops.root import newton_inverse as jax_newton
from g3py_tpu_torch.ops.root import newton_inverse

from torch_parity import floatx

RTOL = 1e-8  # anything through newton_inverse (tests/torch_parity.py)


def _tanh_warp(lib, a, b, c):
    """y + sum_k a_k tanh(b_k (y + c_k)), the WarpingTanh inverse, over any
    shape of y and (n,) parameter vectors."""
    def f(y):
        return y + (lib.tanh(b * (y[..., None] + c)) * a).sum(-1)
    return f


def _params(seed, n=3):
    rng = np.random.default_rng(seed)
    return (np.exp(rng.normal(0.5, 0.5, n)), np.exp(rng.normal(-1.0, 0.5, n)),
            rng.normal(0.0, 2.0, n))


def _torch_solve(z, a, b, c):
    a, b, c = (torch.as_tensor(v) for v in (a, b, c))
    return newton_inverse(_tanh_warp(torch, a, b, c), torch.as_tensor(z))


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_newton_inverse_matches_jax(name):
    a, b, c = _params(0)
    z = np.linspace(-30, 30, 41).reshape(41)
    with floatx(name):
        args = [np.asarray(v, name) for v in (z, a, b, c)]
        want = np.asarray(jax_newton(_tanh_warp(jnp, *map(jnp.asarray, args[1:])),
                                     jnp.asarray(args[0])))
        got = _torch_solve(*args).numpy()
        resid = _tanh_warp(np, *args[1:])(got) - args[0]
    rtol = RTOL if name == "float64" else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    assert np.abs(resid).max() <= (1e-6 if name == "float64" else 1e-4)


def test_implicit_gradient_matches_jax_grad():
    a, b, c = _params(1)
    z = np.linspace(-10, 12, 17)
    w = np.random.default_rng(2).normal(size=z.shape)
    with floatx("float64"):
        def jloss(z_, a_, b_, c_):
            return jnp.sum(jnp.asarray(w) * jax_newton(_tanh_warp(jnp, a_, b_, c_), z_))

        want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (z, a, b, c)))
        leaves = [torch.as_tensor(v).requires_grad_(True) for v in (z, a, b, c)]
        x = newton_inverse(_tanh_warp(torch, *leaves[1:]), leaves[0])
        (torch.as_tensor(w) * x).sum().backward()
        # the value is the root itself: no correction step leaks into it
        np.testing.assert_array_equal(x.detach().numpy(), _torch_solve(z, a, b, c).numpy())
    for got, exp in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp), rtol=RTOL, atol=RTOL)


def test_stiff_warping_converges():
    """The trained WGP3 of the sunsets oracle: b_0 = e^15.42, a near-step
    of height 2 a_0 at y = -c_0, in float32."""
    a = np.exp(np.array([0.691216230392456, -4.986533164978027, 1.4488667249679565]))
    b = np.exp(np.array([15.423553466796875, 4.408346176147461, 0.9148075580596924]))
    c = np.array([-5.699999809265137, -4.447413921356201, -4.489935874938965])
    with floatx("float32"):
        args = [np.asarray(v, "float32") for v in (a, b, c)]
        y = np.linspace(0.0, 200.0, 401, dtype="float32")
        z = _tanh_warp(np, *args)(y).astype("float32")
        got = _torch_solve(z, *args).numpy()
        want = np.asarray(jax_newton(_tanh_warp(jnp, *map(jnp.asarray, args)),
                                     jnp.asarray(z)))
    assert np.all(np.isfinite(got))
    far = np.abs(y - 5.7) > 1e-3  # off the step the inverse is well defined
    np.testing.assert_allclose(got[far], y[far], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rows_stop_on_their_own_like_vmap():
    """A (R, M) solve with per-row parameters: each row as JAX's vmap of
    the solve gives it, and as the row solved alone."""
    rows = [_params(s) for s in (3, 4, 5)]
    z = np.stack([np.linspace(-20, 20, 9) + r for r in range(3)])
    with floatx("float64"):
        a, b, c = (np.stack(v) for v in zip(*rows))

        def one(z_, a_, b_, c_):
            return jax_newton(_tanh_warp(jnp, a_, b_, c_), z_)

        want = np.asarray(jax.vmap(one)(*map(jnp.asarray, (z, a, b, c))))
        ta, tb, tc = (torch.as_tensor(v)[:, None, :] for v in (a, b, c))
        got = newton_inverse(_tanh_warp(torch, ta, tb, tc), torch.as_tensor(z),
                             row_dims=1).numpy()
        alone = np.stack([_torch_solve(z[r], *rows[r]).numpy() for r in range(3)])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(got, alone)
