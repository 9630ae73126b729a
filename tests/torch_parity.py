"""Parity harness between the JAX package and its PyTorch port.

The same numpy inputs, made from a seed, go through a JAX callable and a
torch callable; the results come back as numpy and are compared:

* float32 against float32 at rtol 1e-4, atol 1e-5 — the f32 floor of the
  reference (PARITY.md; ROADMAP Queue 3);
* float64 against JAX under ``jax.enable_x64(True)`` at 1e-10, where a check
  must be tight.

``floatx(name)`` switches both packages' compute dtype and restores it.
The port's entry points run on the card by default; importing this module
puts them on the CPU (``g3t.settings.device = "cpu"``).
"""

import contextlib

import jax
import numpy as np
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t

torch.set_num_threads(1)
g3t.settings.device = "cpu"

F32_TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-10, atol=1e-10)


@contextlib.contextmanager
def floatx(name):
    """Both packages in ``name`` ("float32"/"float64"); float64 also turns
    on JAX's x64 mode.  Restores the previous settings on exit."""
    old_j, old_t = g3.config.settings.floatx, g3t.settings.floatx
    x64 = jax.enable_x64(True) if name == "float64" else contextlib.nullcontext()
    with x64:
        g3.set_floatx(name)
        g3t.set_floatx(name)
        try:
            yield
        finally:
            g3.set_floatx(old_j)
            g3t.set_floatx(old_t)


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return np.asarray(x)


def tol(name):
    return F64_TOL if name == "float64" else F32_TOL


def assert_close(got, want, name="float32", err_msg=""):
    """Recursive allclose at the dtype's parity tolerance."""
    got, want = to_numpy(got), to_numpy(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], name, err_msg=f"{err_msg} [{k}]")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, name, err_msg=f"{err_msg} [{i}]")
        return
    np.testing.assert_allclose(got, want, err_msg=err_msg, **tol(name))


def check(jax_fn, torch_fn, *inputs, name="float32"):
    """Run both callables on the same numpy ``inputs`` (cast to ``name``)
    and compare; returns the (jax, torch) results as numpy."""
    with floatx(name):
        arrs = [np.asarray(a, dtype=name) for a in inputs]
        want = to_numpy(jax_fn(*[jax.numpy.asarray(a) for a in arrs]))
        got = to_numpy(torch_fn(*[torch.as_tensor(a) for a in arrs]))
    assert_close(got, want, name)
    return want, got
