"""The rank side of ``chip_smoke.py``'s phase 19, the band-sharded path on
the card: functions that every rank of a world runs through
:func:`g3py_tpu_torch.parallel.launch.run_local` (this module imports
torch and the port only).

* :func:`world_of_one` (19a): one NCCL rank, GP(Bias, SE) at n=16384,
  d=8, block 256 — ``nll_distributed``'s value and gradient timed (one
  warm and one timed evaluation) with its K1/K2 launches and peak memory,
  beside the single-device loglike in float32 and float64 on the card;
  then the GP and TP band NLLs at phase 5's n=4096 (the reference of 19b).
* :func:`four_ranks` (19b): four gloo ranks sharing one card, phase 5's
  n=4096, block 256 — the GP and TP band NLLs, one timed evaluation with
  the host-clock share of its collectives (each op's calls and ms), ``find_MAP(engine=
  'distributed')`` from the objectives' point (phase 5's MAP moved 10%
  off) and ``predictor_distributed`` on 256 queries at the defaults and at
  phase 5's MAP.
* :func:`gloo_ops` (``--probe``): which collectives gloo takes on CUDA
  tensors, each tried once on two ranks.

Every rank returns host values; the caller checks them.  On the CPU (the
plain kernels, gloo for every world) the same functions run at a small n.
Alone:

    python3 -m g3py_tpu_torch.tools.dist_smoke --probe
"""

import argparse
import json
import time

import numpy as np
import torch

import g3py_tpu_torch as g3t
from g3py_tpu_torch.ops.panel_cholesky import panel_cholesky
from g3py_tpu_torch.ops.stationary_gram import stationary_gram
from g3py_tpu_torch.parallel import cholesky as pchol

__all__ = ["world_of_one", "four_ranks", "gloo_ops"]


def _zero():
    stationary_gram.launches = 0
    panel_cholesky.launches = 0


def _launches():
    return stationary_gram.launches, panel_cholesky.launches


def _on_card():
    return str(g3t.settings.device).startswith("cuda")


def _sync():
    if _on_card():
        torch.cuda.synchronize()


def _peak_gb():
    """Peak allocated device memory since the last reset (None on the CPU)."""
    return torch.cuda.max_memory_allocated() / 1e9 if _on_card() else None


def _model(kind, x, y, name):
    cls = {"gp": g3t.GP, "tp": g3t.TP}[kind]
    proc = cls(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name=name)
    proc.observed(x, y)
    return proc


def _band(proc, u, block):
    """``nll_distributed``'s value and gradient in the flat vector ``u``."""
    ut = torch.tensor(np.asarray(u), dtype=g3t.settings.dtype, device=g3t.settings.device,
                      requires_grad=True)
    v = proc.nll_distributed(proc.active.array_to_dict_tensor(ut), block=block)
    (g,) = torch.autograd.grad(v, ut)
    return float(v), g.double().cpu().numpy()


def _single(proc, u):
    """The single-device ``-loglike`` and its gradient (the port's dense
    path, K1 and K2 over the whole gram)."""
    v, g = proc._value_and_grad(proc._logp_pure(like_only=True),
                                torch.tensor(np.asarray(u), dtype=g3t.settings.dtype,
                                             device=g3t.settings.device))
    return -float(v), -g.double().cpu().numpy()


def _float64(proc, u):
    old = g3t.settings.floatx
    g3t.set_floatx("float64")
    try:
        return _single(proc, np.asarray(u, np.float64))
    finally:
        g3t.set_floatx(old)


def world_of_one(p):
    """19a (see the module docstring)."""
    rng = np.random.default_rng(p["seed"])
    n, d, block = p["n"], p["d"], p["block"]
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    gp = _model("gp", x, y, "P19_GP16")
    u = np.asarray(gp.active.dict_to_array(gp.params_default), np.float32)
    out = {"single32": _single(gp, u)}
    _band(gp, u, block)  # warm
    _zero()
    if _on_card():
        torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.perf_counter()
    out["band"] = _band(gp, u, block)
    _sync()
    out["band_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = _launches()
    out["peak_gb"] = _peak_gb()
    out["float64"] = _float64(gp, u)
    # the GP and TP band NLLs at phase 5's n=4096 (19b's reference), each
    # beside the float64 dense path
    x4, y4 = np.asarray(p["x4"], np.float32), np.asarray(p["y4"], np.float32)
    for kind in ("gp", "tp"):
        proc = _model(kind, x4, y4, f"P19_{kind.upper()}")
        u4 = _start(proc, p["u4"][kind])
        out[kind + "4096"] = {"band": _band(proc, u4, block), "float64": _float64(proc, u4)}
    return out


def _start(proc, u):
    """The flat unconstrained vector ``u`` (phase 5's MAP, in the registry
    order of the same model), or the model's defaults when None."""
    if u is None:
        u = proc.active.dict_to_array(proc.params_default)
    return np.asarray(u, np.float32)


def four_ranks(p):
    """19b (see the module docstring)."""
    import torch.distributed as dist

    x, y = np.asarray(p["x4"], np.float32), np.asarray(p["y4"], np.float32)
    block = p["block"]
    out = {"rank": dist.get_rank()}
    procs = {kind: _model(kind, x, y, f"P19_{kind.upper()}") for kind in ("gp", "tp")}
    us = {kind: _start(proc, p["u4"][kind]) for kind, proc in procs.items()}
    _band(procs["gp"], us["gp"], block)  # warm
    # the collectives' host clock: every collective of parallel/mesh.py goes
    # through torch.distributed by one of these names; the card is
    # synchronized on entry, so an op's time is its own (gloo's host copies
    # and the wait for the other ranks), not the kernels queued before it
    spent = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync()
                calls, seconds = spent.get(name, (0, 0.0))
                spent[name] = (calls + 1, seconds + time.perf_counter() - t0)
        return wrapper

    # the main path, its launches counted from zero: one timed evaluation
    # of each family's objective, the MAP search and the band predictor
    names = [n for n in ("all_reduce", "all_gather_single", "all_gather_into_tensor",
                         "broadcast", "reduce") if hasattr(dist, n)]
    plain = {n: getattr(dist, n) for n in names}
    for n in names:
        setattr(dist, n, timed(n, plain[n]))
    try:
        _sync()
        dist.barrier()
        _zero()
        t0 = time.perf_counter()
        out["gp"] = _band(procs["gp"], us["gp"], block)
        _sync()
        out["eval_ms"] = (time.perf_counter() - t0) * 1e3
        out["eval_launches"] = _launches()
    finally:
        for n in names:
            setattr(dist, n, plain[n])
    out["collectives"] = {n: (c, sec * 1e3) for n, (c, sec) in spent.items()}
    out["collective_share"] = sum(sec for _, sec in spent.values()) * 1e3 / out["eval_ms"]
    out["tp"] = _band(procs["tp"], us["tp"], block)
    t0 = time.perf_counter()
    fit = procs["gp"].find_MAP(engine="distributed", points=1, max_iters=p["max_iters"],
                               start=procs["gp"].active.array_to_dict(us["gp"]),
                               display=False, block=block)
    out["map_s"] = time.perf_counter() - t0
    out["map_u"] = np.asarray(procs["gp"].active.dict_to_array(fit))
    gp, xq = procs["gp"], np.asarray(p["xq"], np.float32)
    out["pred"] = {at: dict(gp.predictor_distributed(
        gp.active.array_to_dict(_start(gp, u)), block=block)(xq, quantiles=True))
        for at, u in (("default", None), ("map", p["u_pred"]))}
    _sync()
    out["launches"] = _launches()
    out["peak_gb"] = _peak_gb()
    return out


def gloo_ops(p):
    """Which collectives gloo takes on CUDA tensors: each op once, its
    error message where it refuses (the probe only; the port's own
    collectives choose their path by the backend's name)."""
    import torch.distributed as dist

    dev, r, w = torch.device("cuda"), dist.get_rank(), dist.get_world_size()
    t = torch.full((4,), float(r + 1), device=dev)
    ops = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(w)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(w * 4, device=dev), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // w, device=dev), t),
        "reduce": lambda: dist.reduce(t.clone(), 0),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as err:  # the probe records the refusal
            out[name] = f"{type(err).__name__}: {str(err).splitlines()[0][:160]}"
        dist.barrier()
    return out


def main():
    from g3py_tpu_torch.parallel.launch import run_local

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true", help="which ops gloo takes on CUDA tensors")
    args = ap.parse_args()
    if args.probe:
        res = run_local(2, "g3py_tpu_torch.tools.dist_smoke:gloo_ops", None, backend="gloo",
                        device="cuda", timeout=300, collective_timeout=60)
        for r, ops in enumerate(res):
            print(f"rank {r}: {json.dumps(ops)}")


if __name__ == "__main__":
    main()
