"""Port parity of the rest of the warping catalogue: ``LinearMapping``,
``LogShifted``, ``BoxCoxShifted``, ``BoxCoxLinear2``, ``SinhArcsinh``,
``Logistic`` and the inv-only ``WarpingBoxCox`` (n=2) and
``MappingInvSum`` (WarpingTanh +^ LinearMapping), whose forward is the
Newton inverse and whose Jacobian is autograd's — inv, forward, logdet and
a WGP's logp, ``dlogp`` (against ``jax.grad``) and predict against the JAX
package in float64 (JAX x64), and over a leading row axis against the
rows one at a time.  The models are tests/test_torch_mappings.py's."""

import numpy as np
import pytest
import torch

from test_torch_mappings import CATALOGUE, INV_ONLY, NEWTON, _pair, _tensors
from torch_parity import assert_process_matches, floatx, jax_eager


@pytest.mark.parametrize("kind", CATALOGUE)
def test_catalogue_mapping_matches_jax_float64(kind):
    """inv, forward and logdet of each warping, then its WGP's logp, dlogp
    and predict (the mean through the Gauss-Hermite moments of the forward),
    closed forms at 1e-10 and anything through the Newton inverse at
    1e-8."""
    with floatx("float64"), jax_eager():
        jp, tp, params, x, y = _pair(kind, name="CAT_WGP")
        pt = _tensors(params)
        yt = torch.as_tensor(y)
        center = float(np.mean(np.asarray(jp.f_mapping.inv(params, y))))
        latent = np.linspace(-2.0, 2.0, 9) + center
        tol = NEWTON if kind in INV_ONLY else dict(rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(tp.f_mapping.inv(pt, yt).numpy(),
                                   np.asarray(jp.f_mapping.inv(params, y)), rtol=1e-10)
        np.testing.assert_allclose(tp.f_mapping(pt, torch.as_tensor(latent)).numpy(),
                                   np.asarray(jp.f_mapping(params, latent)), **tol)
        np.testing.assert_allclose(tp.f_mapping.logdet_dinv(pt, yt).numpy(),
                                   np.asarray(jp.f_mapping.logdet_dinv(params, y)), rtol=1e-10)
        if kind in INV_ONLY:
            np.testing.assert_allclose(tp.logp(params), jp.logp(params), **NEWTON)
            np.testing.assert_allclose(tp.dlogp(params), np.asarray(jp.dlogp(params)), **NEWTON)
            want = jp.predict(params, x[:5], mean=True, std=True)
            got = tp.predict(params, x[:5], mean=True, std=True)
            for k in ("mean", "std"):
                np.testing.assert_allclose(got[k], np.asarray(want[k]), **NEWTON)
        else:
            assert_process_matches(jp, tp, params, x[:5], label=kind)


@pytest.mark.parametrize("kind", CATALOGUE)
def test_catalogue_mapping_rows_match_single_rows(kind):
    with floatx("float64"), torch.no_grad():
        _, tp, params, _, y = _pair(kind, name="CATR_WGP")
        reg = tp.active
        u0 = reg.dict_to_array(params)
        rows = u0[None, :] + 0.05 * np.random.default_rng(4).standard_normal((3, len(u0)))
        prow = reg.array_to_dict_tensor(torch.as_tensor(rows))
        yt = torch.as_tensor(y)
        latent = torch.as_tensor(np.linspace(-1.0, 1.0, 5))[None, :] + tp.f_mapping.inv(
            prow, yt)[:, :5].mean(dim=1, keepdim=True)
        batched = (tp.f_mapping.inv(prow, yt), tp.f_mapping(prow, latent),
                   tp.f_mapping.logdet_dinv(prow, yt))
        for r in range(len(rows)):
            one = {k: v[r] for k, v in prow.items()}
            single = (tp.f_mapping.inv(one, yt), tp.f_mapping(one, latent[r]),
                      tp.f_mapping.logdet_dinv(one, yt))
            for got, want in zip(batched, single):
                np.testing.assert_allclose(got[r].numpy(), want.numpy(), **NEWTON)
        np.testing.assert_allclose(tp.logp_chain(rows), [tp.logp(r, array=True) for r in rows],
                                   **NEWTON)
