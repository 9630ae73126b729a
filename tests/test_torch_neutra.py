"""Port parity of NeuTra (g3py_tpu_torch/bayesian/neutra.py) against the
JAX package's at float64: the whitening layer of ``init_flow``,
``flow_forward``/``flow_inverse`` of a flow carried over by
``flow_from_jax`` (its shape checks too) to 1e-12, 50 steps of the
full-batch Adam fit from the carried initialization (parameters and NLL
trace) to 1e-8, and ``neutra_logp``'s value and gradient over a GP(Bias,
SE) with n=16 (the model's batched gradient through the flow's Jacobian) to
1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g3py_tpu_torch as g3t
from g3py_tpu.bayesian import neutra as jneutra
from g3py_tpu_torch.bayesian import neutra as tneutra
from g3py_tpu_torch.bayesian import samplers as tsam

from torch_parity import KernelSpy, floatx, process_pair


def _draws(m=64, d=3, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 1.5, size=(m, 1))
    return np.concatenate([v, rng.standard_normal((m, d - 1)) * np.exp(v / 2)], axis=1)


def _numpy(params):
    return {"mean": np.asarray(params["mean"]), "chol": np.asarray(params["chol"]),
            "masks": np.asarray(params["masks"]),
            "layers": [{k: np.asarray(v) for k, v in layer.items()}
                       for layer in params["layers"]]}


def test_flow_matches_jax():
    with floatx("float64"):
        draws = _draws()
        init = jneutra.init_flow(3, draws=jnp.asarray(draws), n_couplings=3, hidden=8, key=0)
        # the whitening layer from the same draws
        mine = tneutra.init_flow(3, draws=draws, n_couplings=3, hidden=8, key=0)
        for k in ("mean", "chol", "masks"):
            np.testing.assert_allclose(getattr(mine, k).numpy(), np.asarray(init[k]),
                                       rtol=1e-12, atol=1e-12)
        # couplings that bend: the last layers moved off zero
        rng = np.random.default_rng(2)
        params = _numpy(init)
        for layer in params["layers"]:
            layer["w2"] = 0.3 * rng.standard_normal(layer["w2"].shape)
            layer["b2"] = 0.3 * rng.standard_normal(layer["b2"].shape)
        flow = g3t.flow_from_jax(params)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        z = rng.standard_normal((5, 3))
        for fn in ("flow_forward", "flow_inverse"):
            want = getattr(jneutra, fn)(jparams, jnp.asarray(z))
            got = getattr(tneutra, fn)(flow, torch.as_tensor(z))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
        theta, _ = tneutra.flow_forward(flow, torch.as_tensor(z))
        np.testing.assert_allclose(tneutra.flow_inverse(flow, theta)[0].numpy(), z, rtol=1e-10,
                                   atol=1e-10)


def test_flow_from_jax_checks():
    params = _numpy(jneutra.init_flow(3, n_couplings=2, hidden=4, key=0))
    with pytest.raises(KeyError, match="missing"):
        g3t.flow_from_jax({k: v for k, v in params.items() if k != "chol"})
    with pytest.raises(KeyError, match="unexpected"):
        g3t.flow_from_jax(dict(params, extra=1))
    with pytest.raises(ValueError, match="chol"):
        g3t.flow_from_jax(dict(params, chol=np.eye(2)))
    bad = dict(params, layers=[dict(params["layers"][0], b2=np.zeros(5)), params["layers"][1]])
    with pytest.raises(ValueError, match=r"layers\[0\].b2"):
        g3t.flow_from_jax(bad)
    flow = g3t.flow_from_jax(params)
    assert isinstance(flow, torch.nn.Module) and len(flow.layers) == 2
    assert not any(p.requires_grad for p in flow.parameters())


def test_fit_matches_jax():
    with floatx("float64"):
        draws = _draws(m=128)
        init = jneutra.init_flow(3, draws=jnp.asarray(draws), n_couplings=2, hidden=8, key=3)
        want, want_losses = jneutra._fit_scan(init, jnp.asarray(draws), 50, jnp.asarray(1e-2))
        flow = g3t.flow_from_jax(_numpy(init))
        losses = tneutra._fit(flow, torch.as_tensor(draws), 50, 1e-2)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-8, atol=1e-8)
    assert want_losses[-1] < want_losses[0]
    for layer, jlayer in zip(flow.layers, want["layers"]):
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(getattr(layer, k).numpy(), np.asarray(jlayer[k]),
                                       rtol=1e-8, atol=1e-8, err_msg=k)


def test_neutra_logp_matches_jax(monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(16)
    with floatx("float64"):
        jp, tp = process_pair(lambda lib: lib.GP(space=x, location=lib.Bias(),
                                                 kernel=lib.SE(x), name="NEUTRA_GP"), x, y)
        u0 = tp.active.dict_to_array(tp.params_default)
        draws = u0 + 0.2 * rng.standard_normal((40, len(u0)))
        params = _numpy(jneutra.init_flow(len(u0), draws=jnp.asarray(draws), n_couplings=2,
                                          hidden=6, key=1))
        for layer in params["layers"]:
            layer["w2"] = 0.2 * rng.standard_normal(layer["w2"].shape)
        jlt = jneutra.neutra_logp(jp._sampling_logps()[0], jax.tree_util.tree_map(
            jnp.asarray, params))
        z = 0.5 * rng.standard_normal((3, len(u0)))
        want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(jlt)))(jnp.asarray(z))
        tlt = tneutra.neutra_logp(tp._sampling_logps()[0], g3t.flow_from_jax(params))
        spy = KernelSpy(monkeypatch)
        got_v, got_g = tsam.value_and_grad(tlt, torch.as_tensor(z))
        assert spy.take() == (1, 1)  # the three rows in one batched evaluation
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-8, atol=1e-8)
