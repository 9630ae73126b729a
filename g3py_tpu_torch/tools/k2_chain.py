"""Where the time of one K2 factorization goes, on the card.

    python3 -m g3py_tpu_torch.tools.k2_chain [--n 4096] [--out build/k2_trace]
    python3 -m g3py_tpu_torch.tools.k2_chain --n 4096 16384 --compare OTHER_ROOT

Two measurements of ``panel_cholesky`` in float32 on an SE gram + 0.1 noise
(the matrices ``chip_smoke.py`` phase 2b factors):

* the per-panel timeline: ``torch.profiler`` traces one factorization
  (after a warm-up) and the device events of its trace are cut into panels
  at the starts of the diagonal-tile kernel; each panel's line gives the
  chain interval (from one diagonal-tile start to the next) and every
  kernel or copy that started in it, with its stream (``main``: the
  caller's, ``side``: the lookahead's), grid and duration.  The trace is
  written to ``<out>/k2_trace_n<n>.json``.
* the phase split of ``diag_kernel``: a copy of ``csrc/panel_cholesky.cu``
  compiled with ``-DK2_PHASE_CLOCKS`` (under ``build/``) adds up the
  clock64() cycles of each phase; printed per launch, in cycles and in µs
  at the clock the blocks ran at (globaltimer ns over cycles).

With ``--compare``, instead: the CUDA-event median time of one
factorization (and of ``torch.linalg.cholesky_ex`` beside it), its device
time by kernel and host time a call, ptxas's register counts, and K1's
profiler device time a launch (SE, float32, at (4096, 4096, 8) and (256,
16384, 8), the shapes of ``chip_smoke.py``'s K1 record), in four
processes, this checkout, OTHER_ROOT (another checkout, e.g. the parent
commit unpacked by ``git archive``), OTHER_ROOT, this checkout, so that two
versions are compared on one card in turns.

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops.panel_cholesky import BLOCK, _launch, panel_cholesky
from ..ops.stationary_gram import _plain_form

#: what slot s of the phase clocks times, in csrc/panel_cholesky.cu's diag_kernel
PHASES = ("load tile", "leaf 0", "phase B, all steps", "phase C, wait for the other warps",
          "store L's diagonal leaves and Dinv's last rows", "phase C, warp 0: the leaf's update",
          "phase C, warp 0: factor and invert", "phase C, warp 0: store the leaf",
          "phase C, warp 1: trailing and Z updates", "phase C, warp 4: stores to w and dinv")
SLOTS = 16


def se_gram(n, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, 8, generator=gen, device="cuda")
    a = _plain_form("se", x, x, torch.ones(8, device="cuda"), torch.tensor(1.0, device="cuda"))
    a.diagonal().add_(0.1)
    return a


def _label(evt):
    name = evt["name"]
    grid = evt.get("args", {}).get("grid", [1, 1, 1])
    blocks = grid[0] * grid[1] * grid[2]
    for key, short in (("diag_kernel", "diag"), ("prep_kernel", "prep"),
                       ("finish_kernel", "finish"), ("Memcpy", "memcpy")):
        if key in name:
            return short if short != "diag" else f"diag[{blocks}]"
    if "sgemm_nt_128" in name:
        return f"syrk[{blocks}]"
    if "<true>" in name or "true>" in name:
        return f"upd[{blocks}]"
    if "<false>" in name or "false>" in name:
        return f"prod[{blocks}]"
    return f"{name[:24]}[{blocks}]"


def chain_summary(events):
    """The panels of one traced factorization, from its device events
    (chrome-trace "X" events of category kernel or gpu_memcpy), cut at the
    diagonal-tile starts; None when no diagonal-tile launch is among them.
    Returns a dict: ``side`` (the lookahead's stream), ``span_us`` (first
    event to last), ``panels`` (per panel: start offset, interval to the
    next tile start or the end, and the (stream, label, duration) of every
    event that started in it), ``chains`` (the intervals between tile
    starts), ``busy_us`` per stream and ``diag_us``."""
    events = sorted(events, key=lambda e: e["ts"])
    diags = [e for e in events if "diag_kernel" in e["name"]]
    if not diags:
        return None
    # the lookahead runs every diagonal tile on its side stream
    side = diags[-1]["args"]["stream"]
    t0 = events[0]["ts"]
    span = max(e["ts"] + e["dur"] for e in events) - t0
    bounds = [e["ts"] for e in diags] + [t0 + span]
    busy = {}
    for e in events:
        busy[e["args"]["stream"]] = busy.get(e["args"]["stream"], 0.0) + e["dur"]
    panels = []
    for k in range(len(diags)):
        lo, hi = bounds[k], bounds[k + 1]
        parts = [("side" if e["args"]["stream"] == side else "main", _label(e), e["dur"])
                 for e in events if lo <= e["ts"] < hi]
        panels.append((lo - t0, hi - lo, parts))
    return {"side": side, "span_us": span, "panels": panels,
            "chains": [p[1] for p in panels[:-1]], "busy_us": busy,
            "diag_us": [e["dur"] for e in diags]}


def timeline(n, out_dir, panels=True):
    """Trace one factorization; print its panels (or, without ``panels``,
    only the summary); return a summary dict, or None when the trace holds
    no diagonal-tile launch (the profiler saw no device events)."""
    from torch.profiler import ProfilerActivity, profile

    a = se_gram(n)
    panel_cholesky(a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        panel_cholesky(a)
        torch.cuda.synchronize()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"k2_trace_n{n}.json"
    prof.export_chrome_trace(str(path))
    summary = chain_summary([e for e in json.loads(path.read_text())["traceEvents"]
                             if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy")])
    if summary is None:
        print(f"  timeline n={n}: not measured (no diagonal-tile launch in the trace)", flush=True)
        return None
    span, chains, diag_us = summary["span_us"], summary["chains"], summary["diag_us"]
    print(f"  timeline n={n}: {len(diag_us)} panels, factorization span {span:.1f} us "
          f"(first device event to last), diag_kernel {sum(diag_us):.1f} us in all", flush=True)
    if panels:
        print("    k   start   chain | events that started in the panel: stream label dur(us)",
              flush=True)
        for k, (start, chain, parts) in enumerate(summary["panels"]):
            print(f"    {k:2d} {start:7.1f} {chain:7.1f} | "
                  + ", ".join(f"{who}:{label} {dur:.1f}" for who, label, dur in parts), flush=True)
    for stream, t in sorted(summary["busy_us"].items()):
        print(f"    stream {'side' if stream == summary['side'] else 'main'} ({stream}): busy "
              f"{t:.1f} us = {100 * t / span:.1f}% of the span", flush=True)
    med = statistics.median(chains) if chains else float("nan")
    print(f"    chain interval: median {med:.1f} us, min {min(chains, default=0):.1f}, "
          f"max {max(chains, default=0):.1f}; diag_kernel median {statistics.median(diag_us):.1f} us",
          flush=True)
    return {"span_us": span, "chain_median_us": med, "diag_median_us": statistics.median(diag_us)}


def phase_clocks(n):
    """Build the phase-clock copy of K2, run one factorization, print the
    split of diag_kernel per launch."""
    src = Path(_build.__file__).resolve().parent.parent / "csrc" / "panel_cholesky.cu"
    out = _build._BUILD_DIR / "k2_phase_clocks.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-DK2_PHASE_CLOCKS",
                           "-o", str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the phase-clock copy:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    read = lib.panel_cholesky_phase_cycles
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * SLOTS)()
    a = se_gram(n)
    _launch(a, BLOCK, lib)  # warm-up
    torch.cuda.synchronize()
    if read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the phase clocks failed")
    _launch(a, BLOCK, lib)
    torch.cuda.synchronize()
    if read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the phase clocks failed")
    blocks, ns = buf[SLOTS - 2], buf[SLOTS - 1]
    cycles = sum(buf[:8])  # thread 0's slots
    ns_per_cycle = ns / cycles if cycles else float("nan")
    print(f"  diag_kernel phase clocks n={n}: {blocks} launches, "
          f"{cycles / blocks:.0f} cycles = {ns / blocks / 1e3:.2f} us a launch "
          f"({1 / ns_per_cycle:.3f} GHz)", flush=True)
    for s, name in enumerate(PHASES):
        if s >= 8:  # warps 1 and 4's own clocks: not part of thread 0's total
            print(f"    slot {s} {name:26s} {buf[s] / blocks:9.0f} cycles "
                  f"{buf[s] / blocks * ns_per_cycle / 1e3:7.2f} us", flush=True)
            continue
        c = buf[s] / blocks
        print(f"    slot {s} {name:26s} {c:9.0f} cycles {c * ns_per_cycle / 1e3:7.2f} us "
              f"{100 * buf[s] / cycles:5.1f}%", flush=True)


_TIMES = r"""
import json, re, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from g3py_tpu_torch.ops.panel_cholesky import panel_cholesky
from g3py_tpu_torch.ops.stationary_gram import _plain_form, stationary_gram

def median_ms(fn, reps):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)

def k1_device_ms(m, n, d, reps=20):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x1 = torch.randn(m, d, generator=gen, device="cuda")
    x2 = torch.randn(n, d, generator=gen, device="cuda")
    rate = 0.3 + 0.7 * torch.rand(d, generator=gen, device="cuda")
    var = torch.tensor(1.7, device="cuda")
    for _ in range(3):
        stationary_gram("se", x1, x2, rate, var)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            stationary_gram("se", x1, x2, rate, var)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if "stationary_gram_kernel" in e.key)
    return us / 1e3 / reps if us else None

def registers():  # ptxas's count for the float kernels built in this process
    from g3py_tpu_torch.ops import _build
    regs, name = {}, None
    for rec in _build.build().values():
        for ln in rec.log.splitlines():
            found = re.search(r"entry function '(\w+)'", ln)
            if found:
                name = found.group(1)
            used = re.search(r"Used (\d+) registers", ln)
            kept = name and re.search(KEEP, name)
            if used and kept:
                regs[kept.group(0)] = int(used.group(1))
    return regs

KEEP = (r"stationary_gram_kernelIfLi0E\w{0,4}|prep_kernelIf|finish_kernelIf|sgemm_nt_128|"
        r"sgemm_rows_16ILb[01]|diag_kernelIfLi128")
NAMES = ("prep_kernel", "diag_kernel", "sgemm_rows_16", "sgemm_nt_128", "finish_kernel")

def k2_split(a, reps=10):  # device ms a factorization by kernel; host ms a call
    panel_cholesky(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        panel_cholesky(a)
    host = (time.perf_counter() - t0) * 1e3 / 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            panel_cholesky(a)
        torch.cuda.synchronize()
    split = {k: 0.0 for k in NAMES}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        for k in NAMES:
            if k in e.key:
                split[k] += t / 1e3 / reps
    return {"host_ms_a_call": host, "device_ms": split}

out = {"registers": registers(),
       "k1_device_ms": {f"{m}x{n}x{d}": k1_device_ms(m, n, d)
                        for m, n, d in ((4096, 4096, 8), (256, 16384, 8))}}
for n in map(int, sys.argv[2].split(",")):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, 8, generator=gen, device="cuda")
    a = _plain_form("se", x, x, torch.ones(8, device="cuda"), torch.tensor(1.0, device="cuda"))
    a.diagonal().add_(0.1)
    reps = 10 if n <= 4096 else 3
    out[n] = {"panel_cholesky_ms": median_ms(lambda: panel_cholesky(a), reps),
              "cholesky_ex_ms": median_ms(lambda: torch.linalg.cholesky_ex(a), reps),
              **k2_split(a)}
print(json.dumps(out))
"""


def compare(other, sizes):
    """Time K2 and K1 in this checkout and in ``other``, in turns (this,
    other, other, this), one process each."""
    import sys

    here = str(Path(__file__).resolve().parents[2])
    for root in (here, other, other, here):
        proc = subprocess.run([sys.executable, "-c", _TIMES, root, ",".join(map(str, sizes))],
                              capture_output=True, text=True, cwd=root, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"timing in {root} failed:\n{proc.stdout}{proc.stderr}")
        label = "this checkout" if root == here else f"{other}"
        print(f"  {label}: {proc.stdout.strip().splitlines()[-1]}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[4096])
    ap.add_argument("--out", default="build/k2_trace")
    ap.add_argument("--compare", metavar="OTHER_ROOT")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_chain: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"  {card}; torch {torch.__version__}", flush=True)
    if args.compare:
        compare(args.compare, args.n)
        return
    rec = _build.build()["panel_cholesky"]
    for ln in rec.log.splitlines():  # nvcc -Xptxas -v: each kernel's registers and spills
        if "entry function" in ln or "registers" in ln or "spill stores" in ln:
            print(f"    {ln.strip()[:150]}", flush=True)
    for n in args.n:
        timeline(n, Path(args.out))
        phase_clocks(n)


if __name__ == "__main__":
    main()
