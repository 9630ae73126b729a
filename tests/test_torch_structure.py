"""Port parity of the compositional kernel search (``search_kernel``)
against the JAX package's, float64: the winner, and every evaluated
structure's loglike and criterion at 1e-6 relative, for the ``root``
grammar (``all`` in tests/test_torch_structure_all.py); the error contract (an unknown base, ``criterion='loo'``
on a model without ``loo``, every base failing) and the failure handler,
which scores a candidate whose fit fails numerically as inf and raises a
fault of the card or of a kernel."""

import numpy as np
import pytest
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import floatx


def _data(n=18, seed=4):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 5.0, n)).reshape(-1, 1)
    y = np.sin(2.0 * x[:, 0]) + 0.4 * x[:, 0] + 0.05 * rng.standard_normal(n)
    return x, y


def _table(res):
    return {r["name"]: (r["loglike"], r["criterion"], r["n_params"]) for r in res.table}


def search_matches_jax(expand):
    x, y = _data()
    kw = dict(bases=("SE", "LIN"), depth=1, criterion="bic", points=1, expand=expand)
    with floatx("float64"):
        want = g3.search_kernel(x, y, **kw)
        got = g3t.search_kernel(x, y, **kw)
    assert got.best_name == want.best_name
    tw, tg = _table(want), _table(got)
    assert list(tg) == list(tw)
    for name, (ll, crit, k) in tw.items():
        assert tg[name][2] == k, name
        np.testing.assert_allclose(tg[name][:2], (ll, crit), rtol=1e-6, err_msg=name)
    assert repr(got).startswith("KernelSearch[best=")
    assert isinstance(got.best_kernel(), g3t.Kernel)


def test_search_matches_jax():
    """The ``root`` grammar (``all``: tests/test_torch_structure_all.py)."""
    search_matches_jax("root")


def test_error_contract():
    x, y = _data(n=10)
    with pytest.raises(AttributeError):
        g3t.search_kernel(x, y, bases=("NOPE",))
    with pytest.raises(ValueError, match="criterion"):
        g3t.search_kernel(x, y, criterion="waic")
    with pytest.raises(ValueError, match="expand"):
        g3t.search_kernel(x, y, expand="leaves")
    tp = lambda k: g3t.TP(space=x[:4], location=g3t.Bias(), kernel=k, name="KS_TP")  # noqa
    with pytest.raises(TypeError, match="loo"):
        g3t.search_kernel(x, y, bases=("SE",), criterion="loo", model=tp)


def test_failures_lose_and_card_faults_raise():
    x, y = _data(n=10)

    def broken(kind):
        def build(x_, name=None):
            raise kind
        return build

    zoo = {"SE": g3t.SE, "BAD": broken(torch.linalg.LinAlgError("not positive-definite"))}
    res = g3t.search_kernel(x, y, bases=("SE", "BAD"), depth=0, zoo=zoo)
    assert res.best_name == "SE" and _table(res)["BAD"][1] == np.inf
    with pytest.raises(RuntimeError, match="every base"):
        g3t.search_kernel(x, y, bases=("BAD",), depth=0, zoo=zoo)
    card = {"SE": g3t.SE, "BAD": broken(RuntimeError("stationary_gram kernel launch failed: "
                                                     "cudaError 700"))}
    with pytest.raises(RuntimeError, match="cudaError"):
        g3t.search_kernel(x, y, bases=("SE", "BAD"), depth=0, zoo=card)
