"""Where one state-space evaluation's time goes, on the card.

    python3 -m g3py_tpu_torch.tools.ssm_profile [--laplace]

Profiles (``torch.profiler``, CPU and CUDA activities) one logp + gradient
evaluation, after a warm one, of the two workloads of ``chip_smoke.py``'s
phase 15 that set its bottlenecks: bench.py:352-381's
``StateSpaceGP(MAT32 + OU)`` at n=16384 (15a) and ``SpatioTemporalSSGP``
at 32 sites in 2-D, MAT32 x SE, S=64, 512 events a site (15d), the same
data and params as there.  Prints the card's name and power limit, the
wall time of the profiled evaluation, its device time and event count,
and the device events by kernel (the top 15).  ``--laplace`` profiles
phase 16's Laplace workloads instead (8 Newton steps, CUDA activity only:
a Laplace evaluation is 10^5-10^6 launches): ``NonGaussianSSGP(MAT32,
PoissonLik)`` on benchmarks/ngssm_scale.py's data at n=262,144 (16a) and
the spatio-temporal Cox process ``NonGaussianSTSSGP`` at 32 sites, S=64,
128 events a site (16d), the wall time from an unprofiled evaluation.
Needs a CUDA card.
"""

import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import g3py_tpu_torch as g3t


def ssgp(n=16384, seed=15):
    """15a's model: bench.py's series from a seeded stream, default params."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, n / 50.0, n)).astype(np.float32)
    y = (np.sin(2 * np.pi * t / 20.0) + 0.2 * rng.standard_normal(n)).astype(np.float32)
    proc = g3t.StateSpaceGP(space=t[:4, None], kernel=g3t.MAT32(t[:, None]) + g3t.OU(t[:, None]),
                            name="PROF_SS")
    proc.observed(t[:, None], y)
    return proc, proc.params_default


def stssgp(sites_seed=17, seed=18, per_site=512):
    """15d's model: 32 sites on a jittered 8 x 4 grid, the SE's rate at the
    grid's spacing."""
    rng = np.random.default_rng(sites_seed)
    gx, gy = np.meshgrid(np.arange(8.0), np.arange(4.0))
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    sites = (grid + rng.uniform(-0.2, 0.2, grid.shape)).astype(np.float32)
    rng = np.random.default_rng(seed)
    ts, ys = [], []
    for p in range(len(sites)):
        t = np.sort(rng.uniform(0, 100.0, per_site)).astype(np.float32)
        ts.append(t[:, None])
        ys.append((np.sin(2 * np.pi * t / 20.0 + 0.5 * sites[p, 0]) * np.cos(0.4 * sites[p, 1])
                   + 0.2 * rng.standard_normal(per_site)).astype(np.float32))
    x, y = g3t.stack_outputs(ts, ys)
    proc = g3t.SpatioTemporalSSGP(space=x[:4], kernel=g3t.MAT32(x[:, :1]),
                                  space_kernel=g3t.SE(sites), sites=sites, name="PROF_ST")
    proc.observed(x, y)
    params = dict(proc.params_default)
    params["PROF_ST_SE_rate"] = np.ones(2, np.float32)
    return proc, params


def ngssgp(n=1 << 18, seed=0):
    """16a's model: ngssm_scale.py's counts on (0, 50 n / 16384)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 50.0 * n / 16384, n)).astype(np.float32)
    f = (np.sin(2 * np.pi * t / 20.0) + 0.3 * np.sin(t / 3.0) + 0.5).astype(np.float32)
    y = rng.poisson(np.exp(f)).astype(np.float32)
    proc = g3t.NonGaussianSSGP(space=t[:4, None], kernel=g3t.MAT32(t[:4, None]),
                               likelihood=g3t.PoissonLik(), name="PROF_NG")
    proc.observed(t[:, None], y)
    return proc, proc.params_default


def ngstssgp(sites_seed=17, seed=23, per_site=128):
    """16d's model: the Poisson Cox process on 15d's sites."""
    rng = np.random.default_rng(sites_seed)
    gx, gy = np.meshgrid(np.arange(8.0), np.arange(4.0))
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    sites = (grid + rng.uniform(-0.2, 0.2, grid.shape)).astype(np.float32)
    rng = np.random.default_rng(seed)
    ts, ys = [], []
    for p in range(len(sites)):
        t = np.sort(rng.uniform(0, 100.0, per_site)).astype(np.float32)
        lam = np.exp(0.5 + np.sin(2 * np.pi * t / 20.0 + 0.5 * sites[p, 0])
                     * np.cos(0.4 * sites[p, 1]))
        ts.append(t[:, None])
        ys.append(rng.poisson(lam).astype(np.float32))
    x, y = g3t.stack_outputs(ts, ys)
    proc = g3t.NonGaussianSTSSGP(space=x[:4], kernel=g3t.MAT32(x[:, :1]),
                                 space_kernel=g3t.SE(sites), sites=sites, name="PROF_NGST")
    proc.observed(x, y)
    params = dict(proc.params_default)
    params["PROF_NGST_SE_rate"] = np.ones(2, np.float32)
    return proc, params


def _device(evt):
    return "CPU" not in str(getattr(evt, "device_type", "CPU"))


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(evt, attr, None)
        if t is not None:
            return float(t)
    return 0.0


def report(label, proc, params, count=15, cuda_only=False):
    ut = torch.as_tensor(proc.active.dict_to_array(params), device="cuda")
    pure = proc._logp_pure()

    def evaluate():
        proc._value_and_grad(pure, ut)
        torch.cuda.synchronize()

    evaluate()
    t0 = time.perf_counter()
    if cuda_only:
        evaluate()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            evaluate()
    else:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            evaluate()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages() if _device(e)), key=_device_us, reverse=True)
    total = sum(_device_us(e) for e in rows)
    print(f"{label}: evaluation {wall:.1f} ms of wall, device {total / 1e3:.3f} ms, "
          f"{sum(e.count for e in rows)} device events; top ops:", flush=True)
    for e in rows[:count]:
        t = _device_us(e)
        print(f"  {t / 1e3:10.3f} ms  {100 * t / total:5.1f}%  x{e.count:<6d} {e.key[:90]}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssm_profile: no CUDA device")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    g3t.settings.device = "cuda"
    if "--laplace" in sys.argv[1:]:
        g3t.settings.ssm_laplace_iters = 8
        g3t.settings.ssm_chunk_threshold = 1 << 18
        report("16a NonGaussianSSGP(MAT32, Poisson) n=262144, 8 Newton steps", *ngssgp(),
               cuda_only=True)
        report("16d NonGaussianSTSSGP m=32 S=64 n=4096, 8 Newton steps", *ngstssgp(),
               cuda_only=True)
        return
    report("15a StateSpaceGP(MAT32 + OU) n=16384", *ssgp())
    report("15d SpatioTemporalSSGP m=32 S=64 n=16384", *stssgp())


if __name__ == "__main__":
    main()
