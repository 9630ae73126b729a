"""Run one SPMD function on D local ranks (a small ``torchrun``).

:func:`run_local` starts D fresh interpreters on this module, each of
which joins a process group through a file store (no TCP port, so
concurrent worlds never collide), calls ``target(payload)`` and writes its
result.  A fresh interpreter imports only this package and the target's
module — not the caller's ``__main__``, which the ``spawn`` start method
of ``multiprocessing`` would import in every child — and starts with no
CUDA context, as a spawned child does.  The parent waits for every rank;
any rank that fails or outlives ``timeout`` fails the call, and every
rank is stopped.

    results = run_local(4, "mypkg.work:rank_main", payload, backend="gloo")

``target`` is ``"module:function"``; the function gets ``payload`` and
returns a picklable result, one per rank (rank order).  Each rank sets
``settings.device`` to ``device`` (``"cuda"`` puts NCCL rank r on card
r), and a collective that waits longer than ``collective_timeout`` seconds
raises in its rank, so that a deadlock fails the run instead of hanging
it.
"""

import contextlib
import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time

__all__ = ["run_local"]


def run_local(world, target, payload=None, backend="gloo", device="cpu", threads=None,
              timeout=600.0, collective_timeout=120.0, env=None, workdir=None):
    """``target(payload)`` on ``world`` ranks of a fresh process group;
    the list of their results in rank order.  ``threads`` sets each rank's
    ``torch.set_num_threads``; ``env`` adds environment variables;
    ``workdir`` (an empty directory) holds the store, the logs and the
    results (a temporary directory when None)."""
    with (tempfile.TemporaryDirectory(prefix="g3t_world_") if workdir is None
          else contextlib.nullcontext(str(workdir))) as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as fh:
            pickle.dump(dict(world=world, target=target, payload=payload, backend=backend,
                             device=device, threads=threads,
                             collective_timeout=collective_timeout,
                             store=os.path.join(tmp, "store")), fh)
        child_env = dict(os.environ, **(env or {}))
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        paths = [root] + [p for p in sys.path if p and os.path.isdir(p)]
        child_env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(
            paths + child_env.get("PYTHONPATH", "").split(os.pathsep)))
        with contextlib.ExitStack() as files:
            logs = [files.enter_context(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                    for r in range(world)]
            procs = [subprocess.Popen([sys.executable, "-m", __name__, spec, str(r)],
                                      stdout=logs[r], stderr=subprocess.STDOUT, env=child_env)
                     for r in range(world)]
            deadline = time.monotonic() + timeout
            try:
                while any(p.poll() is None for p in procs):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"run_local: {target} did not finish in {timeout} s")
                    if any(p.poll() not in (None, 0) for p in procs):
                        break  # one rank failed: the others would wait on it
                    time.sleep(0.05)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            failed = [r for r, p in enumerate(procs) if p.returncode != 0]
            if failed:
                tails = []
                for r in failed:
                    logs[r].seek(0)
                    tails.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                                 + logs[r].read()[-4000:])
                raise RuntimeError(f"run_local: {target} failed on rank(s) {failed}\n"
                                   + "\n".join(tails))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def _rank_main(spec_path, rank):
    import torch
    import torch.distributed as dist

    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    from ..config import settings
    settings.device = spec["device"]
    if spec["device"].startswith("cuda") and spec["backend"] == "nccl":
        torch.cuda.set_device(rank)
        settings.device = f"cuda:{rank}"
    dist.init_process_group(spec["backend"], init_method="file://" + spec["store"],
                            world_size=spec["world"], rank=rank,
                            timeout=datetime.timedelta(seconds=spec["collective_timeout"]))
    try:
        module, name = spec["target"].split(":")
        result = getattr(importlib.import_module(module), name)(spec["payload"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(spec_path), f"result{rank}.pkl")
    with open(out + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(out + ".tmp", out)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
