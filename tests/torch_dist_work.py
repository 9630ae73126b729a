"""The rank side of the port's distributed tests: functions that every rank
of a gloo world runs (through :func:`g3py_tpu_torch.parallel.launch.
run_local`, one world a file and a rank count).  It imports the port and
never JAX; the builders take the package (``lib``) as an argument, so that
the test files build the JAX package's twins from the same code.

A world runs ``run(payload)``: every task of its file in order,
``payload["tasks"]`` a list of ``(name, function, keywords)``, each rank
returning ``{name: result}`` of host arrays."""

import numpy as np
import torch

import g3py_tpu_torch as g3t
from g3py_tpu_torch.parallel import mesh as tmesh, cholesky as tchol, sharded as tsh

MU = np.array([0.5, -1.0, 2.0])
SCALE = np.array([1.0, 0.5, 2.0])


def run(payload):
    out = {}
    for name, fn, kw in payload["tasks"]:
        g3t.set_floatx(kw.pop("floatx", "float64"))
        out[name] = globals()[fn](**kw)
    return out


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# the band algebra (tests/test_torch_parallel_cholesky.py)
# ---------------------------------------------------------------------------


def se_cov(p, a, b):
    """A squared-exponential cross covariance written out (the tests' JAX
    twin is the same formula)."""
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return p["var"] * torch.exp(-0.5 * d2 / p["ls"] ** 2)


def _tensors(params):
    return {k: torch.tensor(float(v), dtype=g3t.settings.dtype, requires_grad=True)
            for k, v in params.items()}


def band_algebra(k, b, block):
    """This rank's bands of L, of L^{-1} B and of L^{-T} B."""
    l = tchol.distributed_cholesky(k, block=block)
    return {"l": _np(l), "z": _np(tchol.distributed_trsm(l, b, block=block)),
            "zt": _np(tchol.distributed_trsm_t(l, b, block=block))}


def objective(x, y, params, block, wq, wl):
    """``wq quad + wl logdet_half`` and the GP NLL, each with its gradient
    in the params and y."""
    out = {}
    for label in ("qld", "nll"):
        p, yt = _tensors(params), torch.tensor(y, dtype=g3t.settings.dtype, requires_grad=True)
        xt = torch.tensor(x, dtype=g3t.settings.dtype)
        if label == "qld":
            quad, ld = tchol.distributed_quad_logdet(se_cov, block=block,
                                                     noise_fn=lambda q: q["nv"])(p, xt, yt)
            v = wq * quad + wl * ld
            out["quad"], out["logdet_half"] = _np(quad), _np(ld)
        else:
            v = tchol.distributed_gp_nll(se_cov, block=block, noise_fn=lambda q: q["nv"])(
                p, xt, yt)
        grads = torch.autograd.grad(v, list(p.values()) + [yt])
        out[label] = _np(v)
        out[label + "_grad"] = {k: _np(g) for k, g in zip(list(p) + ["y"], grads)}
    return out


def posterior(x, resid, xq, params, rhs, block):
    """The four closures of ``distributed_posterior``: this rank's bands of
    L and alpha, the query's two psums, the band solve and the cross
    product."""
    state_fn, query_fn, solve_fn, apply_fn = tchol.distributed_posterior(
        se_cov, block=block, noise_fn=lambda q: q["nv"])
    p = {k: torch.tensor(float(v), dtype=g3t.settings.dtype) for k, v in params.items()}
    l, alpha = state_fn(p, x, resid)
    mean_delta, var_red = query_fn(p, x, l, alpha, xq)
    a = solve_fn(l, rhs)
    return {"l": _np(l), "alpha": _np(alpha), "mean_delta": _np(mean_delta),
            "var_red": _np(var_red), "solve": _np(a), "apply": _np(apply_fn(p, x, xq, a))}


def peak(x, y, params, block):
    """Every tensor shape made while this rank evaluates and differentiates
    the GP NLL (a dispatch mode sees each op's outputs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    shapes = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    shapes.add(tuple(t.shape))
            return out

    p, yt = _tensors(params), torch.tensor(y, dtype=g3t.settings.dtype, requires_grad=True)
    nll = tchol.distributed_gp_nll(se_cov, block=block, noise_fn=lambda q: q["nv"])
    with Record():
        v = nll(p, torch.tensor(x, dtype=g3t.settings.dtype), yt)
        torch.autograd.grad(v, list(p.values()) + [yt])
    return sorted(shapes)


# ---------------------------------------------------------------------------
# the model consumers (tests/test_torch_distributed_models.py)
# ---------------------------------------------------------------------------


def build(lib, kind, x, y, name):
    """A GP, WGP, TP or WTP of ``lib`` (either package) on (x, y)."""
    kw = dict(space=x, location=lib.Bias(), kernel=lib.SE(x), name=name)
    if kind == "wgp":
        proc = lib.WGP(mapping=lib.LogShifted(y), **kw)
    elif kind == "wtp":
        proc = lib.WTP(mapping=lib.ArcsinhLinear(y), **kw)
    else:
        proc = {"gp": lib.GP, "tp": lib.TP}[kind](**kw)
    proc.observed(x, y)
    return proc


def nll(kind, x, y, name, params):
    """``nll_distributed`` at ``params`` and its gradient in the flat
    vector, beside this process's own -loglike and its gradient."""
    proc = build(g3t, kind, x, y, name)
    reg = proc.active
    u = torch.tensor(reg.dict_to_array(params), dtype=g3t.settings.dtype, requires_grad=True)
    v = proc.nll_distributed(reg.array_to_dict_tensor(u))
    (g,) = torch.autograd.grad(v, u)
    ll, gll = proc._value_and_grad(proc._logp_pure(like_only=True), u)
    return {"nll": _np(v), "grad": _np(g), "loglike": _np(ll), "loglike_grad": _np(gll)}


def find_map(kind, x, y, name, max_iters, display=False):
    """The distributed MAP; with ``display`` what this rank printed."""
    import contextlib
    import io

    proc = build(g3t, kind, x, y, name)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        p = proc.find_MAP(engine="distributed", points=1, max_iters=max_iters, display=display)
    return {"params": {k: np.asarray(v) for k, v in p.items()}, "logp": proc.logp(p),
            "printed": printed.getvalue()}


def predictor(kind, x, y, name, params, xq, draws, samples, n_features):
    """The band-sharded predictor's statistics (host arrays) and its
    pathwise draws from ``draws`` (the JAX package's)."""
    proc = build(g3t, kind, x, y, name)
    pr = proc.predictor_distributed(params)
    stats = pr(xq, var=True, median=True, quantiles=True, quantiles_noise=True)
    assert all(isinstance(v, np.ndarray) for v in stats.values())
    return {"stats": dict(stats), "l_band": tuple(pr.l_band.shape),
            "draws": pr.sampler(space=xq, samples=samples, key=draws, n_features=n_features,
                                noise=True)}


def experiment(x, y, name):
    e = g3t.Experiment()
    e.add_model(build(g3t, "gp", x, y, name))
    e.set_data(x, y, p=0.75)
    e.set_selection(engine="distributed", engine_kwargs={"max_iters": 40})
    e.run(n_simulations=1)
    return {c: np.asarray(e.results[c]) for c in e.results.columns
            if c.startswith("test_") or c.startswith(name)}


def refusals(x, y, name):
    """The message of ``nll_distributed`` on data that does not split."""
    try:
        build(g3t, "gp", x, y, name).nll_distributed()
    except ValueError as err:
        return str(err)
    return None


# ---------------------------------------------------------------------------
# the sharded samplers and the fan-out (tests/test_torch_parallel_sharded.py)
# ---------------------------------------------------------------------------


def toy_logp(p):
    mu, s = torch.as_tensor(MU, dtype=p.dtype), torch.as_tensor(SCALE, dtype=p.dtype)
    return -0.5 * (((p - mu) / s) ** 2).sum(dim=-1)


def toy_prior(p):
    return -0.05 * (p ** 2).sum(dim=-1)


class _Feed:
    """Hands out the JAX package's draws in the order the port asks."""

    def __init__(self, halves, pairs=None):
        self.halves, self.pairs = list(halves), dict(pairs or {})

    def half(self, gen, shape, n_other, dtype, device):
        u, j, log_u = self.halves.pop(0)
        assert u.shape == shape, (u.shape, shape)
        return (torch.as_tensor(u, dtype=dtype), torch.as_tensor(j, dtype=torch.int64),
                torch.as_tensor(log_u, dtype=dtype))

    def pair(self, seed, rnd, pair, shape, dtype, device):
        u = self.pairs.pop((rnd, pair))
        assert u.shape == shape
        return torch.as_tensor(u, dtype=dtype)


def logp_sharded(kind, x, y, name, u):
    """``sharded_logp_fn``'s value and gradient on this rank's bands, and
    the single-device posterior logp at ``u``."""
    proc = build(g3t, kind, x, y, name)
    fn, place = tsh.sharded_logp_fn(proc)
    bands = place(x, x, y)
    ut = torch.tensor(u, dtype=g3t.settings.dtype, requires_grad=True)
    v = fn(ut, *bands)
    (g,) = torch.autograd.grad(v, ut)
    return {"logp": _np(v), "grad": _np(g), "single": proc.logp(u, array=True),
            "rows": len(bands[0])}


def ensemble(p0, halves, steps):
    from g3py_tpu_torch.bayesian import samplers

    feed, keep = _Feed(halves), samplers._half_draws
    samplers._half_draws = feed.half
    try:
        step, place, logp_rows = tsh.sharded_ensemble_step(toy_logp)
        x = place(p0)
        lp = logp_rows(x)
        for _ in range(steps):
            x, lp = step(None, x, lp)
    finally:
        samplers._half_draws = keep
    assert not feed.halves
    return {"x": _np(step.gather(x)), "local": _np(x)}


def pt(p0, samples, halves, pairs):
    """``pt_sampler_sharded`` with this rank's JAX draws (``halves``: its
    move draws in order; ``pairs``: the exchange uniforms by (round, pair))."""
    from g3py_tpu_torch.bayesian import samplers

    feed = _Feed(halves[tmesh.make_mesh(axis_names=("temps",)).rank], pairs)
    keep = samplers._half_draws, tsh._pair_uniform
    samplers._half_draws, tsh._pair_uniform = feed.half, feed.pair
    try:
        chain = tsh.pt_sampler_sharded(toy_logp, toy_prior, p0, samples)
    finally:
        samplers._half_draws, tsh._pair_uniform = keep
    return {"chain": chain, "left": len(feed.halves)}


def quadratic_obj(u, w):
    scale = 1.0 + torch.arange(1, 3, dtype=u.dtype) * (1.0 + w[:, :1].abs())
    return -(scale * (u - w[:, :2]) ** 2).sum(-1)


def fanout(starts, masks):
    pts, vals = g3t.lbfgs_fanout_sharded(quadratic_obj, starts, masks, max_iters=50, tol=1e-9)
    return {"pts": pts, "vals": vals}


def splits(kind, x, y, name, masks, pair_chunk):
    proc = build(g3t, kind, x, y, name)
    _, vals, pts = g3t.fit_splits(proc, masks, points=2, max_iters=100, tol=1e-8, shard=True,
                                  return_points=True, pair_chunk=pair_chunk)
    return {"vals": vals, "pts": pts}
