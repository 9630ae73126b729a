"""Port parity of the transports: every transport's ``__call__``,
``diag``, ``inv``, ``logdet_dinv`` and ``posterior`` and their ``@``
composition, the posterior of S columns at once (the port pushes all draws
through one joint factorization, the JAX package one a column).  The
transport process (TGP) is tests/test_torch_transport_process.py's.

Tolerances: float64 against JAX x64 at rtol/atol 1e-10, float32 at rtol
1e-4 / atol 1e-5 (``torch_parity``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx

NAMES = ["float32", "float64"]
TRANSPORTS = ["ID", "TLocation", "TScale", "TMapping", "TKernel", "TKernelNoisy", "TComposed"]


def _data(n=20, seed=2):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 6, n).astype(np.float32).reshape(-1, 1)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def _transport(g, kind, x, y):
    if kind == "ID":
        return g.ID()
    if kind == "TLocation":
        return g.TLocation(g.Bias(x))
    if kind == "TScale":
        return g.TScale(g.Bias(x, name="Scale"))
    if kind == "TMapping":
        return g.TMapping(g.BoxCoxLinear(y + 2.0))
    if kind == "TKernel":
        return g.TKernel(g.SE(x))
    if kind == "TKernelNoisy":
        return g.TKernel(g.SE(x), noisy=True)
    return g.TLocation(g.Bias(x)) @ g.TKernel(g.SE(x), noisy=True)


def _tgp_pair(kind, name, x, y):
    jp = g3.TGP(space=x, transport=_transport(g3, kind, x, y), name=name)
    tp = g3t.TGP(space=x, transport=_transport(g3t, kind, x, y), name=name)
    jp.observed(x, y)
    tp.observed(x, y)
    return jp, tp


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", TRANSPORTS)
def test_transport_maps(kind, name):
    """``__call__``, ``diag``, ``inv``, ``logdet_dinv`` and ``posterior`` of
    each transport, and the posterior of S columns at once against the JAX
    package's posterior of each column."""
    with floatx(name):
        x, y = _data()
        yy = y + 2.0 if kind == "TMapping" else y
        jp, tp = _tgp_pair(kind, "TT", x, yy)
        assert list(tp.active.params_spec) == list(jp.active.params_spec)
        # rates 4x the defaults: a noise-free SE gram of the defaults is too
        # ill-conditioned for float32 to mean anything
        params = {k: np.asarray(v) * (4.0 if k.endswith("_rate") else 1.0)
                  for k, v in jp.params_default.items()}
        jpar = {k: jnp.asarray(v) for k, v in params.items()}
        tpar = {k: torch.as_tensor(v) for k, v in params.items()}
        jt, tt = jp.f_transport, tp.f_transport
        xs, ys = x.astype(name), yy.astype(name)
        jx, tx, jy, ty = jnp.asarray(xs), torch.as_tensor(xs), jnp.asarray(ys), torch.as_tensor(ys)
        z = np.random.default_rng(1).standard_normal(len(x)).astype(name)
        jz, tz = jnp.asarray(z), torch.as_tensor(z)
        maps = jax.jit(lambda p, z, yv: [f(p, jx, v, noise=nz) for nz in (False, True)
                                         for f, v in ((jt, z), (jt.diag, z), (jt.inv, yv))]
                       + [jt.logdet_dinv(p, jx, yv)])
        got = [f(tpar, tx, v, noise=nz) for nz in (False, True)
               for f, v in ((tt, tz), (tt.diag, tz), (tt.inv, ty))]
        assert_close(got + [tt.logdet_dinv(tpar, tx, ty)],
                     [np.asarray(w) for w in maps(jpar, jz, jy)], name)
        xq = np.linspace(-0.5, 6.5, 5).astype(name).reshape(-1, 1)
        zq = np.random.default_rng(2).standard_normal((5, 3)).astype(name)
        got = tt.posterior(tpar, torch.as_tensor(xq), torch.as_tensor(zq), tx, ty)
        assert got.shape == (5, 3)
        want = jax.jit(jax.vmap(lambda col: jt.posterior(jpar, jnp.asarray(xq), col, jx, jy),
                                in_axes=1, out_axes=1))(jnp.asarray(zq))
        assert_close(got, np.asarray(want), name)
