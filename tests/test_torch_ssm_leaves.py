"""Port parity of the state-space leaves (``g3py_tpu_torch/ops/ssm.py``)
against the JAX package's ``g3py_tpu/ops/ssm.py``: every leaf's (A, Q,
Pinf, H) over steps with a dt = 0 row (the SE and SM leaves at order 8,
sums and the quasi-periodic product), a params dict of rows against its
rows one by one, the periodic coefficients, and the unrolled inverse and
the PSD-singular-safe Cholesky on a Q=0 rotation block — float64 against
JAX x64 at 1e-10, float32 at rtol 1e-4 / atol 1e-5, the JAX side op by op
(``jax_eager``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g3py_tpu.ops import ssm as J
import g3py_tpu_torch as g3t
from g3py_tpu_torch.ops import ssm as T

from torch_parity import assert_close, floatx, jax_eager, to_numpy
from test_torch_ssm import KERNELS, _jp, _leaves_and_params, _series, _tp

# float32 SE/SM blocks are held in float64 only: their order-8 eigen
# constants reach ~1.4e3, so a float32 A carries that much cancellation
# noise in either package (the JAX package's multiply-reduce and the port's
# product sum in different orders)
LEAF_CASES = ([(k, "float64") for k in sorted(KERNELS)]
              + [(k, "float32") for k in sorted(KERNELS) if k not in ("se", "sm")])


@pytest.mark.parametrize("which,name", LEAF_CASES)
def test_leaf_blocks_match_jax(which, name):
    """(A, Q, Pinf, H) of each leaf over steps with a dt = 0 row."""
    t, y = _series()
    with floatx(name), jax_eager():
        jl, tl, params = _leaves_and_params(which, t, y)
        dt = np.concatenate([[0.0], np.diff(t[:, 0])]).astype(name)
        want = J.ssm_blocks(jl, _jp(params), jnp.asarray(dt))
        got = T.ssm_blocks(tl, _tp(params), torch.as_tensor(dt))
        assert [type(a).__name__ for a in tl] == [type(a).__name__ for a in jl]
        assert_close(got, want, name, err_msg=which)


def test_se_and_sm_leaves_at_order_8():
    t, y = _series()
    with floatx("float64"):
        _, tl, _ = _leaves_and_params("se", t, y)
        assert tl[0].dim == 8 and g3t.settings.ssm_se_order == 8
        _, tl, _ = _leaves_and_params("sm", t, y)
        assert tl[0].dim == 16


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_periodic_coefficients(name):
    with floatx(name), jax_eager():
        for r in (1e-3, 0.7, 4.0, 25.0):
            want = J.periodic_coefficients(jnp.asarray(r, name), 7)
            got = T.periodic_coefficients(torch.tensor(r, dtype=getattr(torch, name)), 7)
            assert_close(got, want, name, err_msg=str(r))
        rows = T.periodic_coefficients(torch.tensor([0.7, 4.0], dtype=getattr(torch, name)), 7)
        assert_close(rows[1], T.periodic_coefficients(torch.tensor(4.0, dtype=rows.dtype), 7),
                     name)


def test_small_inv_and_chol_on_a_rotation_block():
    """COS's Q is exactly 0: the PSD-singular-safe Cholesky gives a zero
    factor (no NaN) as JAX's does; both helpers match JAX on PD and on
    singular PSD stacks."""
    t, y = _series()
    rng = np.random.default_rng(3)
    with floatx("float64"), jax_eager():
        jl, tl, params = _leaves_and_params("cos", t, y)
        dt = np.concatenate([[0.0], np.diff(t[:, 0])])
        _, q, _, _ = T.ssm_blocks(tl, _tp(params), torch.as_tensor(dt))
        assert float(q[1:].abs().max()) < 1e-12
        lq = T.small_chol(q[1:])
        assert torch.isfinite(lq).all() and float(lq.abs().max()) < 1e-6
        g = rng.standard_normal((6, 4, 4))
        pd = g @ np.swapaxes(g, -1, -2) + 4.0 * np.eye(4)
        low = rng.standard_normal((6, 4, 2))
        psd = low @ np.swapaxes(low, -1, -2)              # rank 2
        for m in (pd, psd):
            assert_close(T.small_chol(torch.as_tensor(m)), J.small_chol(jnp.asarray(m)),
                         "float64")
        assert_close(T.small_inv(torch.as_tensor(pd)), J.small_inv(jnp.asarray(pd)), "float64")
        np.testing.assert_allclose(to_numpy(T.small_inv(torch.as_tensor(pd))) @ pd,
                                   np.broadcast_to(np.eye(4), pd.shape), atol=1e-12)


@pytest.mark.parametrize("which", ["sum", "quasi_periodic", "sm"])
def test_leaf_rows_are_their_rows_one_by_one(which):
    """A params dict of R rows gives (R, n, s, s) blocks equal to each
    row's own."""
    t, y = _series()
    with floatx("float64"):
        _, tl, params = _leaves_and_params(which, t, y)
        scale = np.array([0.8, 1.0, 1.3])
        rows = {k: np.stack([np.asarray(v) * f for f in scale]) for k, v in params.items()}
        dt = torch.as_tensor(np.concatenate([[0.0], np.diff(t[:, 0])]))
        got = T.ssm_blocks(tl, _tp(rows), dt)
        assert got[0].shape[:2] == (3, len(t))
        for i in range(3):
            one = T.ssm_blocks(tl, _tp({k: v[i] for k, v in rows.items()}), dt)
            assert_close([x[i] for x in got[:3]] + [got[3]], one, "float64", err_msg=str(i))
