#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``clustertracking_tpu_torch``; no JAX) through its main
path, the bucketed cluster fit, at the reference's headline size: 16,384
two-Gaussian dimers on 64 frames of 256×256, 13×13 windows (bench.py's
configuration).  Phases, one line each:

1. device   — fail unless CUDA is available; the card's name and power
              limit as nvidia-smi reports them;
2. build    — build csrc/fused_lm_2d.cu (nvcc, sm_90a) and time it;
3. kernel   — one fused_lm_2d launch against fused_lm_2d_reference on the
              same CUDA tensors, held to the stated tolerances, and timed;
4. main     — the entry() bucket solver through the full refit-on-shift
              loop; the kernel's launch count, rms and position accuracy;
5. rates    — bucket-solver clusters/s with the kernel and with the plain
              version (bench.py's method), and the serial scipy rate;
6. refine   — refine_leastsq on the same scene as a 32,768-row DataFrame
              (only where pandas imports).

Then one JSON line describing each kernel, and last the contract line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the contract line is not printed.
"""
import json
import subprocess
import sys
import time

import numpy as np

B_FULL = 16384
FRAME = 256
PITCH = 16
BLOCKS = 5            # timed blocks per rate (median reported)
REPS_KERNEL = 16      # solves per timed block, kernel route
REPS_PLAIN = 2        # solves per timed block, plain route
# kernel vs plain on the card: FMA contraction and summation order differ,
# so per-lane agreement is held to these bounds
POS_ATOL = 1e-3       # px, every lane
COST_RTOL = 1e-3      # every lane
AGREE_FRAC = 0.999    # converged / npix equal on at least this share


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return smi


def phase_build():
    from clustertracking_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_kernel_library("fused_lm_2d")
    wall = time.perf_counter() - t0
    nvcc_s, report = _build.build_log("fused_lm_2d")
    ptxas = " ".join(
        line.split(":", 1)[-1].strip() for line in report.splitlines()
        if "registers" in line or "spill" in line
    )
    print(f"[build] fused_lm_2d: nvcc {nvcc_s:.1f} s, load {wall:.1f} s; "
          f"ptxas: {ptxas or 'cached build'}", flush=True)


def _first_round_inputs(batch, device):
    """The fused solve's inputs of the bucket solver's first round."""
    import torch

    from clustertracking_tpu_torch.entry import RADIUS, WINDOW
    from clustertracking_tpu_torch.interop import from_reference
    from clustertracking_tpu_torch.models import build_layout, get_model
    from clustertracking_tpu_torch.ops.gather import origins_for
    from clustertracking_tpu_torch.refine import _slot_bounds

    model = get_model("gauss")
    layout = build_layout(model, 2, True, 2, {})
    st = from_reference(*batch[:5], device=device)
    vect0 = layout.vect_from_params(st.params0)
    pos_at = st.params0[..., list(layout.pos_param_idx)].contiguous()
    origin = origins_for(pos_at, WINDOW, (FRAME, FRAME))
    norm = torch.clamp(torch.amax(st.params0[..., 1].abs(), dim=1), min=1e-6)
    fvalid = torch.ones((vect0.shape[0], 2), device=device)
    lo, hi = _slot_bounds(layout, WINDOW, (FRAME, FRAME))
    args = (vect0, st.params0, st.frames, st.frame_idx, pos_at, origin,
            norm, st.valid, fvalid)
    kw = dict(model=model, layout=layout, window_shape=WINDOW, lo=lo, hi=hi,
              radius=RADIUS, max_iter=60)
    return args, kw, layout


def _cuda_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(batch, device, smi):
    import torch

    from clustertracking_tpu_torch.ops.fused_lm import (
        fused_lm_2d, fused_lm_2d_reference)

    args, kw, layout = _first_round_inputs(batch, device)
    res_k = fused_lm_2d(*args, **kw)
    torch.cuda.synchronize()
    res_p = fused_lm_2d_reference(*args, **kw)
    torch.cuda.synchronize()
    pos_slots = sorted({int(s) for p in layout.pos_param_idx
                        for s in layout.slot_idx[:, p]})
    xk, xp = res_k.x.cpu().numpy(), res_p.x.cpu().numpy()
    ck, cp = res_k.cost.cpu().numpy(), res_p.cost.cpu().numpy()
    pos_err = np.abs(xk[:, pos_slots] - xp[:, pos_slots])
    cost_rel = np.abs(ck - cp) / np.maximum(np.abs(cp), 1e-30)
    conv_eq = float(np.mean(res_k.converged.cpu().numpy()
                            == res_p.converged.cpu().numpy()))
    npix_eq = float(np.mean(res_k.npix.cpu().numpy()
                            == res_p.npix.cpu().numpy()))
    iter_eq = float(np.mean(res_k.n_iter.cpu().numpy()
                            == res_p.n_iter.cpu().numpy()))
    check(np.isfinite(xk).all() and np.isfinite(ck).all(),
          "kernel returned non-finite values")
    ms = _cuda_ms(lambda: fused_lm_2d(*args, **kw), 5)
    plain_ms = _cuda_ms(lambda: fused_lm_2d_reference(*args, **kw), 1)
    print(f"[kernel] {smi}: fused_lm_2d vs plain at B={len(ck)}, 13x13: "
          f"max |dpos| {pos_err.max():.3e} px (tol {POS_ATOL}), "
          f"max cost rel {cost_rel.max():.3e} (tol {COST_RTOL}), "
          f"converged equal {conv_eq:.5f}, npix equal {npix_eq:.5f}, "
          f"n_iter equal {iter_eq:.5f}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms per call", flush=True)
    check(pos_err.max() <= POS_ATOL, "kernel positions disagree")
    check(cost_rel.max() <= COST_RTOL, "kernel cost disagrees")
    check(conv_eq >= AGREE_FRAC, "kernel converged flags disagree")
    check(npix_eq >= AGREE_FRAC, "kernel npix disagrees")
    return dict(max_abs_err=float(pos_err.max()), ms=ms, plain_ms=plain_ms)


def _accuracy(params, rms, truth):
    rms = rms.cpu().numpy()
    pos = params[..., 2:4].cpu().numpy()
    err = np.abs(pos - truth).max(axis=-1).ravel()
    return rms, float(np.median(err))


def phase_main(batch, device, smi):
    import torch

    from clustertracking_tpu_torch import entry
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d

    solve, args = entry(device, batch=batch)
    torch.cuda.synchronize()
    fused_lm_2d.launches = 0
    t0 = time.perf_counter()
    params, rms, conv, iters, _ = solve(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_lm_2d.launches
    rms, med = _accuracy(params, rms, batch[5])
    print(f"[main] {smi}: entry() bucket solver, B={len(rms)}: {launches} "
          f"fused_lm_2d launches, {wall:.3f} s, mean rms {rms.mean():.3e}, "
          f"median |pos - truth| {med:.4f} px, converged "
          f"{float(conv.float().mean()):.4f}, mean LM iters "
          f"{float(iters.float().mean()):.2f}", flush=True)
    check(launches > 0, "the main path did not launch fused_lm_2d")
    check(np.isfinite(rms).all(), "non-finite rms")
    check(rms.mean() < 0.1, f"mean rms {rms.mean()}")
    check(med < 0.05, f"median position error {med} px")
    return launches


def _rate(solve, args, reps_per_block):
    """bench.py's method: a distinct perturbed initial guess per rep (made
    on the device), each block fenced by a device→host copy of its last
    output, the median block rate with its dispersion."""
    import torch

    frames, fidx, params0, pose0, valid = args
    gen = torch.Generator(device=params0.device).manual_seed(1)
    p_reps = [
        params0 + (torch.rand(params0.shape, generator=gen,
                              device=params0.device) * 0.1 - 0.05)
        for _ in range((BLOCKS + 1) * reps_per_block)
    ]
    torch.cuda.synchronize()

    def block(k):
        t0 = time.perf_counter()
        outs = [solve(frames, fidx, p, pose0, valid)
                for p in p_reps[k * reps_per_block:(k + 1) * reps_per_block]]
        outs[-1][1].cpu()
        return len(valid) * reps_per_block / (time.perf_counter() - t0), outs

    block(0)  # warm-up block
    rates, outs = [], None
    for k in range(1, BLOCKS + 1):
        r, outs = block(k)
        rates.append(r)
    for o in outs:
        rms = o[1].cpu().numpy()
        check(np.isfinite(rms).all() and rms.mean() < 0.1,
              "rate-phase fits are bad")
    return float(np.median(rates)), float(max(rates) / min(rates) - 1.0)


def phase_rates(batch, device, smi):
    from clustertracking_tpu_torch.entry import RADIUS, WINDOW, entry
    from clustertracking_tpu_torch.hostref import fit_cluster_scipy
    from clustertracking_tpu_torch.models import get_model
    from clustertracking_tpu_torch.refine import _bucket_solver

    solve, args = entry(device, batch=batch)
    plain, layout = _bucket_solver(
        get_model("gauss"), 2, True, 2, (), WINDOW, RADIUS, (), None, 1e5,
        10, 1.0, 60, 1.49e-8, 1.49e-8, False, "torch",
    )
    rate_p1, disp_p1 = _rate(plain, args, REPS_PLAIN)
    rate_k1, disp_k1 = _rate(solve, args, REPS_KERNEL)
    rate_k2, disp_k2 = _rate(solve, args, REPS_KERNEL)
    rate_p2, disp_p2 = _rate(plain, args, REPS_PLAIN)
    frames, fidx, params0 = batch[0], batch[1], batch[2]
    n_base = 40
    t0 = time.perf_counter()
    for b in range(n_base):
        fit_cluster_scipy(
            frames[fidx[b]], params0[b].astype(float), layout.slot_idx,
            WINDOW, RADIUS, True, norm=150.0,
        )
    scipy_rate = n_base / (time.perf_counter() - t0)
    print(f"[rates] {smi}: bucket solver B={len(fidx)} clusters/s — "
          f"kernel {rate_k1:.1f} (disp {disp_k1:.3f}), {rate_k2:.1f} "
          f"(disp {disp_k2:.3f}); plain {rate_p1:.1f} (disp {disp_p1:.3f}), "
          f"{rate_p2:.1f} (disp {disp_p2:.3f}); serial scipy on the host "
          f"{scipy_rate:.1f} ({n_base} clusters)", flush=True)


def phase_refine(batch, device, smi):
    try:
        import pandas as pd
    except ImportError:
        print("[refine] pandas is not installed: refine_leastsq phase "
              "not run", flush=True)
        return
    from clustertracking_tpu_torch import diagnostics, refine_leastsq
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d

    frames, fidx, params0, truth = batch[0], batch[1], batch[2], batch[5]
    B, n = params0.shape[:2]
    f = pd.DataFrame({
        "frame": np.repeat(fidx, n),
        "y": params0[:, :, 2].ravel().astype(float),
        "x": params0[:, :, 3].ravel().astype(float),
        "signal": 150.0,
        "size": 2.5,
    })
    before = fused_lm_2d.launches
    t0 = time.perf_counter()
    with diagnostics.collect() as stats:
        out = refine_leastsq(f, frames, diameter=9, separation=6.0,
                             device=device)
    wall = time.perf_counter() - t0
    cost = out["cost"].to_numpy()
    err = np.abs(out[["y", "x"]].to_numpy() - truth.reshape(-1, 2))
    med = float(np.median(err.max(axis=1)))
    sizes = sorted({int(s) for s in out["cluster_size"]})
    print(f"[refine] {smi}: refine_leastsq on {len(f)} rows / "
          f"{len(np.unique(fidx))} "
          f"frames: {wall:.2f} s, {len(stats.batches)} dispatches "
          f"{sorted({b.backend for b in stats.batches})}, cluster sizes "
          f"{sizes}, {fused_lm_2d.launches - before} kernel launches, "
          f"accepted {np.isfinite(cost).mean():.4f}, mean cost "
          f"{np.nanmean(cost):.3e}, median |pos - truth| {med:.4f} px",
          flush=True)
    check(np.isfinite(cost).all(), "refine_leastsq rejected fits")
    check(np.nanmean(cost) < 0.1, "refine_leastsq mean cost")
    check(med < 0.05, f"refine_leastsq median position error {med} px")
    check(fused_lm_2d.launches > before, "refine_leastsq bypassed the kernel")


def main():
    smi = phase_device()
    import torch

    from clustertracking_tpu_torch.entry import example_batch

    device = "cuda"
    phase_build()
    batch = example_batch(B=B_FULL, frame_size=FRAME, grid_pitch=PITCH,
                          with_truth=True)
    k = phase_kernel(batch, device, smi)
    launches = phase_main(batch, device, smi)
    phase_rates(batch, device, smi)
    phase_refine(batch, device, smi)
    print(json.dumps({"kernels": [{
        "name": "fused_lm_2d",
        "route": "cuda",
        "source": "clustertracking_tpu_torch/csrc/fused_lm_2d.cu",
        "replaces": "clustertracking_tpu/ops/pallas_lm.py:1213",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
