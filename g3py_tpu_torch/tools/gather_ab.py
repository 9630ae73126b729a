"""Which all_gather the band path pays for over gloo on CUDA tensors:
gloo's own ``all_gather_into_tensor`` (A, what ``parallel/mesh.py`` calls)
against an ``all_reduce`` into a zero-filled buffer (B), each a run of
``chip_smoke.py`` phase 19b's four ranks sharing one card
(:func:`g3py_tpu_torch.tools.dist_smoke.four_ranks`: GP n=4096, d=8,
block 256, one timed evaluation, every collective timed), the runs in the
order A B B A, repeated ``--pairs`` times.  Needs one card:

    python3 -m g3py_tpu_torch.tools.gather_ab --pairs 3
"""

import argparse
import json
import subprocess

import numpy as np

__all__ = ["gather_by_sum", "rank_main"]


def gather_by_sum(mesh, t, axis="dp"):
    """The ranks' ``t`` concatenated along rows, as an all_reduce of a
    zero-filled buffer that holds this rank's rows (variant B)."""
    import torch.distributed as dist

    d = mesh.axis_size(axis)
    if d == 1:
        return t
    r, rows = mesh.axis_index(axis), t.shape[0]
    out = t.new_zeros((d * rows,) + tuple(t.shape[1:]))
    out[r * rows:(r + 1) * rows] = t
    dist.all_reduce(out, group=mesh.axis_group(axis))
    return out


def rank_main(p):
    """One rank of a run: variant B swaps the band path's all_gather."""
    from g3py_tpu_torch.parallel import cholesky as pchol, mesh as tmesh
    from g3py_tpu_torch.tools import dist_smoke

    if p["variant"] == "B":
        tmesh.all_gather = pchol.all_gather = gather_by_sum
    out = dist_smoke.four_ranks(p)
    return {k: out[k] for k in ("eval_ms", "collectives", "collective_share")}


def main():
    import g3py_tpu_torch as g3t
    from g3py_tpu_torch.ops import _build
    from g3py_tpu_torch.parallel.launch import run_local

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3, help="A B B A blocks, two pairs each")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build()  # the ranks load the kernels this process built
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, 8)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(4096)).astype(np.float32)
    g3t.settings.device, g3t.settings.floatx = "cuda", "float32"
    gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="P19_GP")
    gp.observed(x, y)
    payload = dict(x4=x, y4=y, u4={"gp": None, "tp": None}, block=256, max_iters=3,
                   xq=np.random.default_rng(192).standard_normal((256, 8)).astype(np.float32),
                   u_pred=np.asarray(gp.active.dict_to_array(gp.params_default), np.float32))
    evals = {"A": [], "B": []}
    for variant in "ABBA" * args.pairs:
        ranks = run_local(4, "g3py_tpu_torch.tools.gather_ab:rank_main",
                          dict(payload, variant=variant), backend="gloo", device="cuda",
                          timeout=600, collective_timeout=120)
        evals[variant].append(max(r["eval_ms"] for r in ranks))
        print(json.dumps({"variant": variant, "eval_ms": [r["eval_ms"] for r in ranks],
                          "collective_share": [r["collective_share"] for r in ranks],
                          "rank0_ops": ranks[0]["collectives"]}), flush=True)
    wins = sum(b < a for a, b in zip(evals["A"], evals["B"]))
    print(json.dumps({"A_ms": evals["A"], "B_ms": evals["B"], "B_wins": wins,
                      "pairs": len(evals["A"])}), flush=True)


if __name__ == "__main__":
    main()
