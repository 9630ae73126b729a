"""Port parity of ``BayesOpt.suggest`` and ``BayesOpt.run`` against the
JAX package's (float64): q=1 and q=2 from the same seed (the same screen,
the same Adam ascent, picks within 1e-8), one K2 factorization a
conditioning set and K1 at the counts the design predicts; ``run`` on
tutorial 18's 1-D problem at 2 iterations (the refits through scipy's BFGS
in both packages, the history within 1e-6)."""

import numpy as np
import pytest

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from test_torch_bo import _pair
from torch_parity import KernelSpy, floatx


@pytest.mark.parametrize("kind,q", [("logEI", 1), ("UCB", 2)])
def test_suggest_matches_jax(kind, q, monkeypatch):
    kw = dict(kind=kind, q=q, candidates=96, starts=4, steps=10, liar="mean")
    with floatx("float64"):
        jb, tb, params = _pair("gp")
        want = jb.suggest(params, **kw)
        spy = KernelSpy(monkeypatch)
        got = tb.suggest(params, **kw)
        k1, k2 = spy.take()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    # a factorization a conditioning set; K1 for its gram, the screen, each
    # Adam step, the final starts and the believer's mean
    assert k2 == q
    assert k1 == q * (1 + 1 + kw["steps"] + 1) + (q if q > 1 else 0)



def test_run_matches_jax_on_the_tutorials_1d_problem():
    def f_multi(x):
        x = np.atleast_2d(x)
        return (np.sin(3 * x[..., 0]) + 0.7 * np.cos(5 * x[..., 0])
                - 0.1 * (x[..., 0] - 1) ** 2)

    out = []
    with floatx("float64"):
        for lib in (g3, g3t):
            gp = lib.GP(space=np.zeros((4, 1)), location=lib.Bias(), kernel=lib.SE(1),
                        noisy=True, name="BO_RUN")
            bo = lib.BayesOpt(gp, bounds=[[0.0, 4.0]], maximize=True, seed=1, xi=0.05)
            _, hist = bo.run(f_multi, iters=2, init=6, kind="UCB", candidates=128, steps=20)
            out.append((np.stack(hist["x"]), np.asarray(hist["y"]), bo.best()[1]))
    (jx, jy, jbest), (tx, ty, tbest) = out
    assert len(ty) == 8 and np.isfinite(ty).all()
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbest, jbest, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="liar"):
        g3t.BayesOpt(g3t.GP(space=np.zeros((4, 1)), location=g3t.Bias(), kernel=g3t.SE(1),
                            name="BO_BAD"), bounds=[[0.0, 1.0]]).suggest(kind="UCB", q=2,
                                                                          liar="nope")
    with pytest.raises(ValueError, match="high > low"):
        g3t.BayesOpt(None, bounds=[[1.0, 0.0]])
