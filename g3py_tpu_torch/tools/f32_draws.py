"""Where float32 rounding enters the posterior draws of an ill-conditioned
GP, stage by stage, on the card and on the CPU.

    python3 -m g3py_tpu_torch.tools.f32_draws [--n 4096] [--m 1024] [--newton]

The workload of ``chip_smoke.py`` phase 10c: GP(Bias, SE) on phase 5's data
(n points, d=8, ``numpy.random.default_rng(0)``) at its float32 MAP
(``find_MAP(points=1, powell=False)`` on the card), one noisy posterior draw
loc + chol(C) z at m queries, C = K_ss + s2 I - V'V, V = L^{-1} K_Xs.  Each
stage of the port's path in float32 (the gram, K2's factor and panel
inverses, L^{-1} from the panels, alpha, V, C, chol(C), the draw) is held
to a float64 numpy/scipy recomputation from the same float32 inputs, on the
card and with the plain forms on the CPU.  Then the draw is recomputed on
the card with one stage at a time swapped for another implementation (the
CPU's plain factor, the float64 factor rounded to float32, a triangular
solve for L^{-1}, ...): the stage whose swap moves the draw's gap is where
the card's float32 error comes from.  Every gap is max |got - ref| / max
|ref|.

With ``--newton``: the Newton solve of ``ops/root.py`` with its host loop
against its ``while_loop`` form (what an exported warping runs), both
eager, on the warpings of
``chip_smoke.py`` phases 7c and 9e (WarpingTanh n=3, WarpingBoxCox,
MappingInvSum) at the point counts of a 256-query Predictor batch.

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def gap(got, ref):
    got = got.detach().double().cpu().numpy() if torch.is_tensor(got) else got
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def host_gram(a, b, rate, var):
    acc = np.zeros((a.shape[0], b.shape[0]), a.dtype)
    for k in range(a.shape[1]):
        acc += ((a[:, k, None] - b[None, :, k]) * rate[k]) ** 2
    return var * np.exp(-0.5 * acc)


def reference(p, x, y, xq, z, dtype=np.float64):
    """The stages from the float32 inputs in ``dtype`` with scipy's
    triangular solves (float64: the reference; float32: a host witness)."""
    import scipy.linalg

    x, xq, y, z = (a.astype(dtype) for a in (x, xq, y, z))
    p = {k: np.asarray(v, dtype) for k, v in p.items()}
    n, m = len(x), len(xq)
    k = host_gram(x, x, p["rate"], p["var"]) + p["noise"] * np.eye(n, dtype=dtype)
    chol = scipy.linalg.cholesky(k, lower=True)
    linv = scipy.linalg.solve_triangular(chol, np.eye(n, dtype=dtype), lower=True)
    resid = y - p["bias"]
    alpha = scipy.linalg.cho_solve((chol, True), resid)
    cross = host_gram(xq, x, p["rate"], p["var"])
    v = scipy.linalg.solve_triangular(chol, cross.T, lower=True)
    kss = host_gram(xq, xq, p["rate"], p["var"]) + p["noise"] * np.eye(m, dtype=dtype)
    c = kss - v.T @ v
    cchol = np.linalg.cholesky(c)
    mean = p["bias"] + cross @ alpha
    out = dict(K=k, cross=cross, kss=kss, L=chol, linv=linv, alpha=alpha, V=v, C=c,
               cholC=cchol, mean=mean, draw=mean + cchol @ z)
    if dtype == np.float64:
        s = np.linalg.eigvalsh(k)
        out["cond"] = float(s[-1] / s[0])
    return out


def port_inputs(gp, u, x, y, xq, device):
    """The port's float32 gram, cross gram, query gram and residual of the
    row ``u`` on ``device`` (each with the row axis of one row)."""
    from g3py_tpu_torch import settings
    from g3py_tpu_torch.ops.guards import to_cov, to_num

    old = settings.device
    settings.device = device
    try:
        p = gp.active.array_to_dict_tensor(torch.as_tensor(u[None], device=device))
        xt, xqt = (torch.as_tensor(a, device=device) for a in (x, xq))
        kn = gp.f_kernel_noise
        return dict(K=to_cov(kn.cov(p, xt)), cross=to_num(kn.cov(p, xqt, xt)),
                    kss=kn.cov(p, xqt),
                    resid=torch.as_tensor(y, device=device) - gp.f_location(p, xt),
                    loc=gp.f_location(p, xqt))
    finally:
        settings.device = old


def factor(k, how):
    """(L, dinv) of the (1, n, n) float32 stack ``k`` (on the card):
    ``k2`` the kernel, ``plain`` the plain form on the CPU, ``f64`` the
    plain form in float64 rounded to float32."""
    from g3py_tpu_torch.ops.panel_cholesky import panel_cholesky

    if how == "k2":
        chol, dinv, _ = panel_cholesky(k)
    elif how == "plain":
        chol, dinv, _ = panel_cholesky(k.cpu())
    else:
        chol, dinv, _ = panel_cholesky(k.double().cpu())
    return chol.to(k.device, k.dtype), dinv.to(k.device, k.dtype)


def linv_of(chol, dinv, how):
    """L^{-1}: ``panels`` the port's trtri_from_panels, ``trsm`` a
    triangular solve against I (torch.linalg.solve_triangular)."""
    from g3py_tpu_torch.ops.linalg import trtri_from_panels

    if how == "panels":
        return trtri_from_panels(chol, dinv)
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)


def stages(inp, z, factor_how="k2", linv_how="panels", post_how="k2", v_how="linv",
           f64_products=False):
    """The draw's stages from the port's inputs ``inp`` with the named
    implementation of each stage (on a CPU ``inp``, ``k2`` is the plain
    form); ``f64_products`` forms alpha, V and V'V in float64 from the
    float32 L^{-1}, grams and residual."""
    chol, dinv = factor(inp["K"], factor_how)
    linv = linv_of(chol, dinv, linv_how)
    wide = torch.float64 if f64_products else linv.dtype
    lw, cw = linv.to(wide), inp["cross"].to(wide)
    alpha = torch.matmul(lw.transpose(-1, -2), torch.matmul(lw, inp["resid"].to(wide)[..., None]))
    if v_how == "linv":
        v = torch.matmul(lw, cw.transpose(-1, -2))
    else:  # a triangular solve against the factor
        v = torch.linalg.solve_triangular(chol, inp["cross"].transpose(-1, -2), upper=False)
    c = (inp["kss"].to(v.dtype) - torch.matmul(v.transpose(-1, -2), v)).to(linv.dtype)
    cchol, _ = factor(c, post_how)
    mean = (inp["loc"].to(wide) + torch.matmul(cw, alpha)[..., 0]).to(linv.dtype)
    draw = mean + torch.matmul(cchol, z[:, None])[..., 0]
    return dict(L=chol[0], dinv=dinv[0], linv=linv[0], alpha=alpha[0, :, 0], V=v[0], C=c[0],
                cholC=cchol[0], mean=mean[0], draw=draw[0])


def row_report(gp, u, x, y, xq, z, main_device):
    """The stages of row ``u`` on ``main_device`` and on the CPU, then the
    swaps on ``main_device``, each against the float64 host."""
    nat, start = {}, 0
    for par in gp.active.ordered_params:  # natural values, rounded as the card holds them
        seg = np.asarray(u[start:start + par.size], np.float64)
        val = np.exp(seg) if par.prior.transform.name == "log" else seg
        nat["_".join(par.name.split("_")[-2:])] = val.astype(np.float32).astype(np.float64)
        start += par.size
    pref = {"rate": nat["SE_rate"], "var": float(nat["SE_var"][0]),
            "bias": float(nat["Bias_Bias"][0]), "noise": float(nat["Noise_var"][0])}
    ref = reference(pref, x, y, xq, z)
    ref32 = reference(pref, x, y, xq, z, np.float32)
    out = {"cond": ref["cond"], "noise_var": pref["noise"], "se_var": pref["var"],
           "scipy_float32": {k: gap(ref32[k], ref[k]) for k in ("V", "C", "mean", "draw")}}
    print(f"  cond(K) {ref['cond']:.3e}, noise var {pref['noise']:.4e}, SE var "
          f"{pref['var']:.4e}; scipy in float32 (triangular solves) vs float64: "
          f"{json.dumps(out['scipy_float32'])}", flush=True)
    keys = ("L", "linv", "alpha", "V", "C", "cholC", "mean", "draw")
    n = len(x)
    inputs = {}
    out["stages"] = {}
    for device in dict.fromkeys((main_device, "cpu")):
        inp = inputs[device] = port_inputs(gp, u, x, y, xq, device)
        st = stages(inp, torch.as_tensor(z, device=device))
        rec = {k: gap(inp[k][0], ref[k]) for k in ("K", "cross", "kss")}
        rec.update({k: gap(st[k], ref[k]) for k in keys})
        chol64 = torch.as_tensor(ref["L"])
        rec["L_backward"] = gap(st["L"].double().cpu() @ st["L"].double().cpu().T, ref["K"])
        rec["linv_L_minus_I"] = float((st["linv"].double().cpu() @ chol64
                                       - torch.eye(n, dtype=torch.float64)).abs().max())
        out["stages"][device] = rec
        print(f"  {device} float32 stages vs float64: {json.dumps(rec)}", flush=True)

    inp = inputs[main_device]
    cpu_grams = {k: v.to(main_device) for k, v in inputs["cpu"].items()}
    zt = torch.as_tensor(z, device=main_device)
    swaps = {"port (k2, panels, k2)": (inp, {}),
             "grams: the CPU's plain form": (cpu_grams, {}),
             "factor: plain form on the CPU": (inp, dict(factor_how="plain")),
             "factor: float64 rounded to float32": (inp, dict(factor_how="f64")),
             "L^{-1}: triangular solve": (inp, dict(linv_how="trsm")),
             "V: triangular solve against L": (inp, dict(v_how="trsm")),
             "chol(C): float64 rounded to float32": (inp, dict(post_how="f64")),
             "products alpha, V, V'V in float64": (inp, dict(f64_products=True)),
             "grams of the CPU, products in float64": (cpu_grams, dict(f64_products=True))}
    out["swaps"] = {}
    for label, (src, kw) in swaps.items():
        st = stages(src, zt, **kw)
        rec = {k: gap(st[k], ref[k]) for k in ("linv", "V", "C", "mean", "draw")}
        out["swaps"][label] = rec
        print(f"  swap {label}: {json.dumps(rec)}", flush=True)
    return out


def draws_report(n, m, main_device="cuda"):
    import g3py_tpu_torch as g3t

    g3t.settings.device, g3t.settings.floatx = main_device, "float32"
    brng = np.random.default_rng(0)  # chip_smoke.py phase 5's data
    x = brng.standard_normal((n, 8)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * brng.standard_normal(n)).astype(np.float32)
    xq = np.random.default_rng(102).standard_normal((m, 8)).astype(np.float32)
    z = np.random.default_rng(7).standard_normal(m).astype(np.float32)
    gp = g3t.GP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), name="TRAIN_GP")
    gp.observed(x, y)
    params = gp.find_MAP(points=1, powell=False, display=False)
    # chip_smoke.py phase 6d's sampler from the MAP and its 16 rows
    chain, lnprob = gp.sample_hypers(start=params, samples=20, chains=22, seed=4, raw=True,
                                     noise_mult=0.02)
    dt = g3t.chains_to_datatrace(gp, chain, ll=lnprob, burnin_tol=None)
    inside = np.flatnonzero(dt["_ll"] > -1e29)
    rows = np.asarray(dt[inside[np.linspace(0, len(inside) - 1, 16).astype(int)]][
        gp.active.param_names()])
    out = {}
    for label, u in (("MAP", gp.active.dict_to_array(params)), ("row 0", rows[0]),
                     ("row 15", rows[15])):
        print(f"GP(Bias, SE) n={n}, m={m}, float32, {label}:", flush=True)
        out[label] = row_report(gp, np.asarray(u, np.float32), x, y, xq, z, main_device)
    return out


def newton_report(device, reps=20):
    import g3py_tpu_torch as g3t
    from g3py_tpu_torch.ops.root import _solve

    rng = np.random.default_rng(103)
    x = rng.standard_normal((256, 8)).astype(np.float32)
    y = (np.abs(np.sin(x[:, 0])) + 0.5).astype(np.float32)
    maps = {"WarpingTanh n=3": lambda: g3t.WarpingTanh(y, n=3),
            "WarpingBoxCox": lambda: g3t.WarpingBoxCox(y, n=2),
            "MappingInvSum": lambda: g3t.MappingInvSum(g3t.WarpingTanh(y, name="Tanh"),
                                                       g3t.LinearMapping(y))}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {}
    for label, build in maps.items():
        wgp = g3t.WGP(space=x[:4], location=g3t.Bias(), kernel=g3t.SE(x), mapping=build(),
                      name="NEWTON")
        wgp.observed(x, y)
        reg = wgp.active
        p = reg.array_to_dict_tensor(torch.as_tensor(reg.dict_to_array(wgp.params_default),
                                                     device=device))
        mp = wgp.f_mapping
        rec = {}
        for count in (256, 256 * g3t.settings.quadrature_degree):
            zz = torch.as_tensor(rng.standard_normal(count).astype(np.float32), device=device)
            times, vals = {}, {}
            for traced in (False, True, False, True):
                def f():
                    return _solve(lambda v: mp.inv(p, v) - zz, torch.zeros_like(zz), 1e-6, 100,
                                  1.0, 0, lambda v: mp.inv_slope(p, v), traced)
                try:
                    vals[traced] = f()
                except Exception as err:  # eager while_loop goes through torch.compile
                    times["while_loop"] = f"failed: {type(err).__name__}: {str(err)[:200]}"
                    continue
                sync()
                ts = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    f()
                    sync()
                    ts.append((time.perf_counter() - t0) * 1e3)
                times.setdefault("while_loop" if traced else "host loop", []).append(
                    statistics.median(ts))
            times["same_values"] = (bool(torch.equal(vals[False], vals[True]))
                                    if True in vals else None)
            rec[count] = times
        out[label] = rec
        print(f"newton {label}: median ms a solve (two rounds each, in turns) {json.dumps(rec)}",
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--newton", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cpu: the plain forms throughout (a dry run of the script)")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("f32_draws: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        print(card_line(), f"torch {torch.__version__}", flush=True)
        from g3py_tpu_torch.ops import _build
        _build.build()
    report = {"draws": draws_report(args.n, args.m, args.device)}
    if args.newton:
        report["newton"] = newton_report(args.device)
    print(json.dumps(report, default=float))


if __name__ == "__main__":
    main()
