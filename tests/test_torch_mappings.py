"""Port parity of the warpings the sunsets oracle uses: ``WarpingTanh``
(inv-only: the forward is the Newton inverse, the Jacobian autograd's),
``ArcsinhLinear`` and the composition ``BoxCoxLinear @ ArcsinhLinear`` —
inv, forward, logdet and a WGP's logp and ``dlogp`` against the JAX
package, and over a leading row axis against the rows one at a time.  The
rest of the catalogue is in tests/test_torch_mappings_catalogue.py, which
builds its warpings with :func:`_mapping` and :func:`_pair` here."""

import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx

# WarpingTanh n=1 is WGP1 of tests/test_torch_parity.py's oracle replay
KINDS = ["tanh3", "arcsinh", "boxcox@arcsinh"]
# closed forms at 1e-10; anything through newton_inverse or autograd's
# Jacobian at 1e-8 relative (tests/torch_parity.py)
NEWTON = dict(rtol=1e-8, atol=1e-8)


# the rest of the catalogue; the last two are inv-only (Newton forward)
CATALOGUE = ["linear", "logshifted", "boxcoxshifted", "boxcox2", "sinharcsinh", "logistic",
             "warpingboxcox2", "invsum"]
INV_ONLY = ("warpingboxcox2", "invsum")


def _mapping(lib, kind, y):
    more = {"linear": lambda: lib.LinearMapping(y),
            "logshifted": lambda: lib.LogShifted(y),
            "boxcoxshifted": lambda: lib.BoxCoxShifted(y),
            "boxcox2": lambda: lib.BoxCoxLinear2(y),
            "sinharcsinh": lambda: lib.SinhArcsinh(y),
            "logistic": lambda: lib.Logistic(y),
            "warpingboxcox2": lambda: lib.WarpingBoxCox(y, n=2),
            "invsum": lambda: lib.hypers.mappings.MappingInvSum(
                lib.WarpingTanh(y, name="Tanh"), lib.LinearMapping(y))}
    if kind in more:
        return more[kind]()
    if kind.startswith("tanh"):
        return lib.WarpingTanh(y, n=int(kind[4:]))
    if kind == "arcsinh":
        return lib.ArcsinhLinear(y)
    return lib.BoxCoxLinear(y) @ lib.ArcsinhLinear(y)


def _pair(kind, name="MAP_WGP", n=24):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, 2))
    y = np.abs(np.sin(2 * x[:, 0])) * 20 + 2.0 + rng.standard_normal(n)
    out = []
    for lib in (g3, g3t):
        wgp = lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                      mapping=_mapping(lib, kind, y), name=name)
        wgp.observed(x, y)
        out.append(wgp)
    params = {k: np.asarray(v) * (1.0 + 0.1 * np.sign(np.asarray(v)))
              for k, v in out[0].params_default.items()}
    return out[0], out[1], params, x, y


def _tensors(params):
    return {k: torch.as_tensor(np.asarray(v, g3t.settings.floatx)) for k, v in params.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_mapping_matches_jax_float64(kind):
    with floatx("float64"):
        jp, tp, params, x, y = _pair(kind)
        pj, pt = params, _tensors(params)
        latent = np.linspace(-3.0, 3.0, 13) + float(np.mean(np.asarray(jp.f_mapping.inv(pj, y))))
        tol = NEWTON if kind.startswith("tanh") else {}
        checks = [(jp.f_mapping.inv(pj, y), tp.f_mapping.inv(pt, torch.as_tensor(y)), {}),
                  (jp.f_mapping(pj, latent), tp.f_mapping(pt, torch.as_tensor(latent)), tol),
                  (jp.f_mapping.logdet_dinv(pj, y),
                   tp.f_mapping.logdet_dinv(pt, torch.as_tensor(y)), tol),
                  (jp.logp(params), tp.logp(params), tol),
                  (jp.dlogp(params), tp.dlogp(params), tol)]
        for i, (want, got, t) in enumerate(checks):
            got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_allclose(got, np.asarray(want), err_msg=f"{kind} check {i}",
                                       **(t or dict(rtol=1e-10, atol=1e-10)))


@pytest.mark.parametrize("kind", ["tanh3", "boxcox@arcsinh"])
def test_wgp_logp_dlogp_match_jax_float32(kind):
    with floatx("float32"):
        jp, tp, params, _, _ = _pair(kind, name="MAP32_WGP")
        assert_close(tp.logp(params), jp.logp(params))
        assert_close(tp.dlogp(params), np.asarray(jp.dlogp(params)), err_msg=kind)


@pytest.mark.parametrize("kind", ["tanh3", "boxcox@arcsinh"])
def test_mapping_rows_match_single_rows(kind):
    """A params dict of R rows maps like R single dicts (inv, forward,
    logdet), and ``logp_chain`` over rows matches the JAX package's."""
    with floatx("float64"), torch.no_grad():
        jp, tp, params, _, y = _pair(kind, name="ROWS_WGP")
        reg = tp.active
        u0 = reg.dict_to_array(params)
        rows = u0[None, :] * (1.0 + 0.05 * np.random.default_rng(3).standard_normal((4, len(u0))))
        prow = reg.array_to_dict_tensor(torch.as_tensor(rows))
        yt = torch.as_tensor(y)
        latent = torch.as_tensor(np.linspace(-2.0, 2.0, 5))[None, :] + tp.f_mapping.inv(
            prow, yt)[:, :5].mean(dim=1, keepdim=True)
        batched = (tp.f_mapping.inv(prow, yt), tp.f_mapping(prow, latent),
                   tp.f_mapping.logdet_dinv(prow, yt))
        for r in range(len(rows)):
            one = {k: v[r] for k, v in prow.items()}
            single = (tp.f_mapping.inv(one, yt), tp.f_mapping(one, latent[r]),
                      tp.f_mapping.logdet_dinv(one, yt))
            for got, want in zip(batched, single):
                np.testing.assert_allclose(got[r].numpy(), want.numpy(), **NEWTON)
        np.testing.assert_allclose(tp.logp_chain(rows), np.asarray(jp.logp_chain(rows)), **NEWTON)


def test_composition_names_and_defaults():
    _, tp, _, _, _ = _pair("boxcox@arcsinh", name="NAMES_WGP")
    jp = _pair("boxcox@arcsinh", name="NAMES_WGP")[0]
    assert str(tp.f_mapping).count("@") == 1
    assert [p.name for p in tp.active.ordered_params] == \
        [p.name for p in jp.active.ordered_params]
    for k, v in jp.params_default.items():
        np.testing.assert_allclose(tp.params_default[k], np.asarray(v), rtol=1e-6)

