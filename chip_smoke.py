"""On-card smoke run of the PyTorch/CUDA port (g3py_tpu_torch).

Drives the port's main path — exact GP and warped-GP regression served from
one factorization — on one CUDA card, through the hand-written stationary
gram kernel, and checks it:

  phase 0  require a CUDA card; print its name and power limit
  phase 1  build the kernel from csrc/ with nvcc
  phase 2  kernel vs its plain PyTorch version: 4 families x f32/f64 x 5
           shapes, CUDA-event times at the serving shapes, autograd check
  phase 3  GP(Bias, SE) at n=16384, d=8: logp, Predictor, 8 query batches
           of 256 points (mean, std, quantiles, noise bands)
  phase 4  WGP(Bias, MAT52, BoxCoxLinear) at n=4096, d=8 served the same
           way; then a GP(Bias, SE) at n=4096 held against a float64
           numpy/scipy recomputation on the host

Every check raises on failure.  The last two lines are the kernel record
and ``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import g3py_tpu_torch as g3t
from g3py_tpu_torch.ops.stationary_gram import KINDS, build, stationary_gram, _plain_form

SHAPES = [(4096, 4096, 8), (256, 16384, 8), (1000, 777, 8), (300, 200, 1), (129, 65, 37)]
TIMED_SHAPES = SHAPES[:2]
TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 1e-14)}  # rtol, atol/var


def require(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def finite(t):
    return bool(torch.isfinite(t).all())


# ---------------------------------------------------------------- phase 2
def phase2():
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    timing = {}
    for dtype in (torch.float32, torch.float64):
        rtol, atol_rel = TOL[dtype]
        for m, n, d in SHAPES:
            x1 = torch.randn(m, d, generator=gen, device=dev, dtype=dtype)
            x2 = torch.randn(n, d, generator=gen, device=dev, dtype=dtype)
            rate = 0.3 + 0.7 * torch.rand(d, generator=gen, device=dev, dtype=dtype)
            var = torch.tensor(1.7, device=dev, dtype=dtype)
            alpha = torch.tensor(0.8, device=dev, dtype=dtype)
            for kind in KINDS:
                extra = alpha if kind == "rq" else None
                out = stationary_gram(kind, x1, x2, rate, var, extra)
                torch.cuda.synchronize()
                ref = _plain_form(kind, x1, x2, rate, var, extra)
                err = (out - ref).abs()
                max_err = float(err.max())
                ok = bool((err <= atol_rel * 1.7 + rtol * ref.abs()).all())
                print(f"  {str(dtype)[6:]:8s} {kind:5s} ({m},{n},{d}) max_abs_err={max_err:.3e}",
                      flush=True)
                require(ok and finite(out) and out.shape == (m, n),
                        f"{kind} {dtype} ({m},{n},{d}) disagrees with the plain form "
                        f"(max abs err {max_err:.3e})")
                worst = max(worst, max_err)
                if dtype == torch.float32 and (m, n, d) in TIMED_SHAPES:
                    t_k = event_ms(lambda: stationary_gram(kind, x1, x2, rate, var, extra))
                    t_p = event_ms(lambda: _plain_form(kind, x1, x2, rate, var, extra))
                    timing[(kind, (m, n, d))] = (t_k, t_p)
                    print(f"    time f32 {kind} ({m},{n},{d}): kernel {t_k:.4f} ms, "
                          f"plain {t_p:.4f} ms", flush=True)
    # autograd: the Function's backward vs the plain form's autograd
    for kind in ("se", "rq"):
        m, n, d = 129, 65, 37
        base = [torch.randn(m, d, generator=gen, device=dev, dtype=torch.float64),
                torch.randn(n, d, generator=gen, device=dev, dtype=torch.float64),
                0.3 + 0.7 * torch.rand(d, generator=gen, device=dev, dtype=torch.float64),
                torch.tensor(1.7, device=dev, dtype=torch.float64),
                torch.tensor(0.8, device=dev, dtype=torch.float64)]
        w = torch.randn(m, n, generator=gen, device=dev, dtype=torch.float64)
        grads = []
        for fn in (stationary_gram, _plain_form):
            leaves = [t.clone().requires_grad_(True) for t in base]
            extra = leaves[4] if kind == "rq" else None
            (fn(kind, *leaves[:4], extra) * w).sum().backward()
            grads.append([t.grad for t in leaves[:4]] + ([leaves[4].grad] if extra is not None else []))
        for gk, gp in zip(*grads):
            require(torch.allclose(gk, gp, rtol=1e-10, atol=1e-12),
                    f"{kind} gradient disagrees with the plain form's autograd")
        print(f"  autograd {kind}: gradients of x1, x2, rate, var"
              f"{', alpha' if kind == 'rq' else ''} match the plain form", flush=True)
    return worst, timing


# ---------------------------------------------------------------- phase 3/4
def serve(process, rng, batches, m, d, label):
    """logp, Predictor and ``batches`` query batches; returns per-batch ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logp = process.logp()
    t_logp = time.perf_counter() - t0
    require(math.isfinite(logp) and logp > -1e29, f"{label} logp {logp} is not finite")
    t0 = time.perf_counter()
    pr = process.predictor()
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    print(f"  {label}: logp={logp:.6f} ({t_logp * 1e3:.1f} ms), "
          f"predictor built in {t_pred * 1e3:.1f} ms", flush=True)
    times = []
    for b in range(batches):
        xq = rng.standard_normal((m, d)).astype(np.float32)
        t0 = time.perf_counter()
        out = pr(xq, mean=True, std=True, quantiles=True, quantiles_noise=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for k in ("mean", "std", "quantile_up", "quantile_down", "noise_std",
                  "noise_up", "noise_down"):
            require(out[k].shape == (m,) and out[k].is_cuda and finite(out[k]),
                    f"{label} batch {b}: {k} is not a finite ({m},) CUDA tensor")
        require(bool((out["std"] > 0).all()), f"{label} batch {b}: std <= 0")
        require(bool((out["quantile_down"] <= out["quantile_up"]).all()),
                f"{label} batch {b}: quantile_down > quantile_up")
        require(bool((out["noise_down"] <= out["noise_up"]).all()),
                f"{label} batch {b}: noise_down > noise_up")
    print(f"  {label}: {batches} batches of {m}: per batch median "
          f"{statistics.median(times):.3f} ms, first {times[0]:.3f} ms, "
          f"all {[round(t, 3) for t in times]}", flush=True)
    return times


def host_check(rng):
    """GP(Bias, SE) at n=4096 vs a float64 numpy/scipy recomputation."""
    import scipy.linalg

    n, d, m = 4096, 8, 256
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    xq = rng.standard_normal((m, d)).astype(np.float32)
    gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="HOSTGP")
    gp.observed(x, y)
    params = gp.params_default
    logp = gp.logp(params)
    out = gp.predictor(params)(xq)
    mean, std = out["mean"].cpu().numpy(), out["std"].cpu().numpy()

    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    bias, var = p["HOSTGP_Bias_Bias"], p["HOSTGP_SE_var"]
    rate, noise = p["HOSTGP_SE_rate"], p["HOSTGP_Noise_var"]
    x64, xq64, y64 = x.astype(np.float64), xq.astype(np.float64), y.astype(np.float64)

    def gram(a, b):
        acc = np.zeros((a.shape[0], b.shape[0]))
        for k in range(d):
            acc += ((a[:, k, None] - b[None, :, k]) * rate[k]) ** 2
        return var * np.exp(-0.5 * acc)

    chol = scipy.linalg.cholesky(gram(x64, x64) + noise * np.eye(n), lower=True)
    resid = y64 - bias
    zz = scipy.linalg.solve_triangular(chol, resid, lower=True)
    ref_logp = -0.5 * n * np.log(2 * np.pi) - 0.5 * zz @ zz - np.log(np.diag(chol)).sum()
    cross = gram(xq64, x64)
    alpha = scipy.linalg.cho_solve((chol, True), resid)
    ref_mean = bias + cross @ alpha
    v = scipy.linalg.solve_triangular(chol, cross.T, lower=True)
    ref_std = np.sqrt(np.maximum(var - (v * v).sum(axis=0), 0.0))
    gaps = {"logp": abs(logp - ref_logp) / abs(ref_logp),
            "mean": float(np.abs(mean - ref_mean).max() / np.abs(ref_mean).max()),
            "std": float(np.abs(std - ref_std).max() / np.abs(ref_std).max())}
    print(f"  host f64 check GP n={n}: logp {logp:.6f} vs {ref_logp:.6f}; relative gaps "
          + ", ".join(f"{k}={v:.3e}" for k, v in gaps.items()), flush=True)
    for k, gap in gaps.items():
        require(gap <= 1e-3, f"host check: {k} relative gap {gap:.3e} > 1e-3")


def main():
    print("phase 0: device", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    print("phase 1: build", flush=True)
    rec = build()
    regs = [ln.strip() for ln in rec.log.splitlines() if "registers" in ln]
    print(f"  built {rec.path} in {rec.seconds:.2f} s (cached={rec.cached})", flush=True)
    for ln in regs:
        print("   ", ln)

    print("phase 2: kernel vs plain form", flush=True)
    worst, timing = phase2()

    g3t.settings.device = "cuda"
    g3t.settings.floatx = "float32"
    rng = np.random.default_rng(0)
    d = 8

    stationary_gram.launches = 0
    print("phase 3: GP serving n=16384 d=8", flush=True)
    n = 16384
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="SMOKE_GP16")
    gp.observed(x, y)
    serve(gp, rng, batches=8, m=256, d=d, label="GP n=16384")
    after_gp = stationary_gram.launches
    print(f"  stationary_gram launches in GP serving: {after_gp}", flush=True)
    require(after_gp >= 2 + 8, f"GP serving launched the kernel {after_gp} times, "
            "expected >= 1 (logp) + 1 (state) + 8 (batches)")

    print("phase 4: WGP serving n=4096 d=8", flush=True)
    n2 = 4096
    x2 = rng.standard_normal((n2, d)).astype(np.float32)
    y2 = (np.abs(np.sin(x2[:, 0])) + 0.5 + 0.1 * rng.standard_normal(n2)).astype(np.float32)
    wgp = g3t.WGP(space=x2[:4], location=g3t.Bias(), kernel=g3t.MAT52(x2),
                  mapping=g3t.BoxCoxLinear(y2), name="SMOKE_WGP")
    wgp.observed(x2, y2)
    serve(wgp, rng, batches=8, m=256, d=d, label="WGP n=4096")
    launches = stationary_gram.launches
    print(f"  stationary_gram launches in WGP serving: {launches - after_gp}", flush=True)
    require(launches - after_gp >= 2 + 8, "WGP serving did not go through the kernel")
    host_check(rng)

    t_k, t_p = timing[("se", (256, 16384, 8))]
    record = {"kernels": [{
        "name": "stationary_gram", "route": "cuda",
        "source": "g3py_tpu_torch/csrc/stationary_gram.cu",
        "replaces": "g3py_tpu/ops/pallas_gram.py:80",
        "launches": launches, "max_abs_err": worst, "ms": t_k, "plain_ms": t_p}]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
