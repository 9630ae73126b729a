"""Port parity of ``StateSpaceGP`` (``g3py_tpu_torch/models/statespace.py``)
against the JAX package in float64 at 1e-10: the hyper names and defaults,
logp, dlogp and the moment statistics (posterior and prior, with and
without noise, the log predictive) from one program of the JAX package
(``torch_parity.jax_logp_dlogp``), the quantiles, and
the joint sampler, posterior and prior, fed the JAX package's normals
(rebuilt from its key splits).  The chunked routing, the rows, the
predictor and ``find_MAP`` are ``tests/test_torch_statespace_rows.py``'s,
``MultiStateSpaceGP`` ``tests/test_torch_statespace_multi.py``'s and the
golden pins ``tests/test_torch_parity.py``'s.  The JAX side is compiled,
one program a quantity set (``torch_parity.FAST_COMPILE``): op by op, its
scans' backward takes minutes."""

import contextlib

import jax.numpy as jnp
import numpy as np
from jax import random

import g3py_tpu as g3
import g3py_tpu_torch as g3t

from torch_parity import assert_close, floatx, jax_compiled_method, jax_logp_dlogp, to_numpy

F64 = "float64"


def _series(n=24, seed=1, span=10.0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, n)).reshape(-1, 1)
    t[7] = t[6]                                        # a duplicate time
    y = np.sin(t[:, 0]) + 0.1 * rng.standard_normal(n)
    return t, y


def _ssgp(lib, t, kernel="sum"):
    k = {"sum": lambda: lib.MAT32(t) + lib.OU(t),
         "quasi": lambda: lib.SIN(t) * lib.MAT52(t) + lib.COS(t)}[kernel]()
    return lib.StateSpaceGP(space=t, location=lib.Bias(), kernel=k, name="SS_" + kernel)


def _mssgp(lib, shared=False):
    rng = np.random.default_rng(4)
    t0 = np.sort(rng.uniform(0, 8, 13))[:, None]
    t1 = np.sort(rng.uniform(0, 8, 10))[:, None]
    y0 = np.sin(t0[:, 0]) + 0.1 * rng.standard_normal(13)
    y1 = -0.6 * np.sin(t1[:, 0]) + 0.4 + 0.1 * rng.standard_normal(10)
    x, y = lib.stack_outputs([t0, t1], [y0, y1])
    kernel = lib.MAT32(t0) if shared else [lib.MAT32(t0, name="KA"), lib.OU(t0, name="KB")]
    proc = lib.MultiStateSpaceGP(space=x, kernel=kernel, outputs_dim=2, name="MS%d" % shared)
    proc.observed(x, y)
    return proc, x, y


@contextlib.contextmanager
def chunked(threshold=12, chunk=8):
    """Both packages' state-space chunking lowered (and restored)."""
    old = [(s, s.ssm_chunk_threshold, s.ssm_chunk) for s in (g3.config.settings, g3t.settings)]
    for s, _, _ in old:
        s.ssm_chunk_threshold, s.ssm_chunk = threshold, chunk
    try:
        yield
    finally:
        for s, th, ch in old:
            s.ssm_chunk_threshold, s.ssm_chunk = th, ch


def _nudged(params, seed=0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) * (1.0 + 0.1 * rng.uniform(-1, 1, np.shape(v)))
            for k, v in params.items()}


def jax_normals(seed, samples, n, s, prior=False, res=None, dtype=jnp.float64):
    """The JAX package's draws of ``_joint_draws(seed=...)``: its key
    splits, as the port's ``seed={...}`` dict."""
    key = random.PRNGKey(seed)
    out = {}
    if res is not None:
        key, kres = random.split(key)
        out["res"] = np.asarray(random.normal(kres, res, dtype=dtype))
    keys = random.split(key, samples)
    if prior:
        out["x"] = np.stack([np.asarray(random.normal(k, (n, s), dtype=dtype)) for k in keys])
        return out
    xs, ys = [], []
    for k in keys:
        k1, k2 = random.split(k)
        xs.append(np.asarray(random.normal(k1, (n, s), dtype=dtype)))
        ys.append(np.asarray(random.normal(k2, (n,), dtype=dtype)))
    out["x"], out["y"] = np.stack(xs), np.stack(ys)
    return out


def _pair(build, *args):
    out = []
    for lib in (g3, g3t):
        out.append(build(lib, *args))
    return out


#: the moment statistics held to the JAX package's: posterior and prior
#: mean, variance (with and without noise) and log predictive
STATS = {f"{key}{prior}": (th, dict(kw, prior=prior)) for prior in (False, True)
         for key, th, kw in (("mean", "th_mean", {}), ("var", "th_variance", {}),
                             ("varn", "th_variance", {"noise": True}),
                             ("lp", "th_logpredictive", {}))}


def _stats(tp, p, xq, y_q):
    """The port's :data:`STATS` at p (host numpy)."""
    return to_numpy({k: getattr(tp, th[3:])(p, xq, vector=y_q, **kw)
                     for k, (th, kw) in STATS.items()})


def assert_port_quantities(tp, p, xq):
    """The port's own kernel_diag equals its variance and its quantiles are
    the normal ones of its (JAX-checked) moments."""
    from scipy import stats

    for prior in (False, True):
        assert_close(tp.kernel_diag(p, xq, prior=prior), tp.variance(p, xq, prior=prior), F64)
    m, v = to_numpy(tp.mean(p, xq)), to_numpy(tp.variance(p, xq, noise=True))
    assert_close(tp.quantiler(p, xq, q=0.9, noise=True),
                 stats.norm.ppf(0.9, loc=m, scale=np.sqrt(v)), F64)


def assert_logp_dlogp(jp, tp, p, xq=None, y_q=None):
    """The port's logp, dlogp and (at ``xq``) :data:`STATS` equal the JAX
    package's, from one program of it."""
    if xq is None:
        value, grad = jax_logp_dlogp(jp, p)
    else:
        value, grad, want = jax_logp_dlogp(jp, p, xq, STATS, vector=y_q)
        assert_close(_stats(tp, p, xq, y_q), want, F64)
    assert_close(tp.logp(p), value, F64)
    assert_close(tp.dlogp(p), grad, F64)


def assert_names_and_defaults(jp, tp):
    assert [q.name for q in tp.active.ordered_params] == \
        [q.name for q in jp.active.ordered_params]
    for k, v in jp.params_default.items():
        np.testing.assert_array_equal(tp.params_default[k], np.asarray(v), err_msg=k)


def test_ssgp_matches_jax():
    t, y = _series()
    tq = np.linspace(-0.5, 10.5, 11)[:, None]
    with floatx(F64):
        jp, tp = _pair(_ssgp, t)
        for proc in (jp, tp):
            proc.observed(t, y)
        assert_names_and_defaults(jp, tp)
        p = _nudged(jp.params)
        assert_logp_dlogp(jp, tp, p, tq, np.cos(tq[:, 0]))
        assert_port_quantities(tp, p, tq)


def test_ssgp_sampler_matches_jax():
    """Posterior and prior joint draws from the JAX package's normals; the
    noise from the same numpy Generator; a seed draws on the device."""
    t, y = _series(n=16)
    tq = np.linspace(0.5, 9.5, 9)[:, None]
    with floatx(F64):
        jp, tp = _pair(_ssgp, t)
        for proc in (jp, tp):
            proc.observed(t, y)
        jax_compiled_method(jp, "_joint_draws")
        p = _nudged(jp.params, seed=1)
        s = sum(leaf.dim for leaf in tp._leaves)
        post = jax_normals(3, 2, len(t) + len(tq), s)
        want = jp.sampler(p, tq, samples=2, seed=3, noise=True, rng=np.random.default_rng(9))
        assert_close(tp.sampler(p, tq, samples=2, seed=post, noise=True,
                                rng=np.random.default_rng(9)), want, F64)
        prior = jax_normals(5, 2, len(tq), s, prior=True)
        assert_close(tp.sampler(p, tq, samples=2, prior=True, seed=prior),
                     jp.sampler(p, tq, samples=2, prior=True, seed=5), F64)
        seeded = tp.sampler(p, tq, samples=3, seed=0)
        assert seeded.shape == (len(tq), 3) and np.isfinite(seeded).all()
