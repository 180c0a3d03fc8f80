#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``clustertracking_tpu_torch``; no JAX) through its main
paths, the bucketed cluster fit, at the reference's own sizes: 16,384
two-Gaussian dimers on 64 frames of 256×256 in 13×13 windows (bench.py's
configuration), and config 4 of benchmarks/suite.py, 2,048 anisotropic
3D dimers in 8 z-stacks of 64×192×192 in 9×13×13 windows.  Phases, one
line each:

1. device   — fail unless CUDA is available; the card's name and power
              limit as nvidia-smi reports them;
2. build    — build csrc/fused_lm_2d.cu, window_gather.cu and pixel_lm.cu
              (one nvcc each, sm_90a, started together) and time them;
3. kernel   — one fused_lm_2d launch against fused_lm_2d_reference on the
              same CUDA tensors, held to the stated tolerances, and timed;
4. main     — the entry() bucket solver through the full refit-on-shift
              loop; the kernel's launch count, rms and position accuracy;
5. rates    — bucket-solver clusters/s with the kernel and with the plain
              version (bench.py's method), and the serial scipy rate;
6. refine   — refine_leastsq on the same scene as a 32,768-row DataFrame
              (only where pandas imports);
7. kernel3d — config 4's first-round inputs: window_gather against
              gather_stack (bit-equal), pixel_lm resident and forced
              streamed against pixel_lm_reference and each other, timed;
              then both modes against the plain version on the same scene
              with noise, where cost is compared on every lane;
8. main3d   — the entry_3d() bucket solver (the gathered route), with
              pixel_lm's mode picked by occupancy (streamed on an H100)
              and with resident forced; launch counts, rms and position
              accuracy;
9. rates3d  — config 4 clusters/s, gathered route and plain route at
              B=2,048, gathered route at B=16,384 with the kernels'
              occupancy;
10. profile3d — torch.profiler at B=16,384: gather vs solve vs the rest,
              and the device's idle share;
11. stream2d — the entry scene with 161×161 windows, which only the
              streamed gathered route takes, against the plain route;
12. refine3d — refine_leastsq on config 4's scene as a DataFrame.

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
# A fit that reaches float32 resolution (config 4 is noise-free and fits
# every size) ends at rms ~1e-7..1e-6 of the signal scale, where its cost
# is rounding noise: a position 1e-5 px off the optimum, well inside
# POS_ATOL, moves such an rms by ~1e-6.  So on a lane whose rms is below
# RMS_FLOOR in both versions the cost is not compared (positions still
# are); 1e-5 of the signal scale is far below any camera's noise.
RMS_FLOOR = 1e-5
B_3D = 2048
B_3D_BIG = 16384
STREAM_WINDOW = (161, 161)
STREAM_RADIUS = (6.5, 6.5)
KERNELS = ("fused_lm_2d", "window_gather", "pixel_lm")


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
    _build.build_kernels(KERNELS)
    wall = time.perf_counter() - t0
    for name in KERNELS:
        nvcc_s, report = _build.build_log(name)
        ptxas = " ".join(
            line.split(":", 1)[-1].strip() for line in report.splitlines()
            if "registers" in line or "spill" in line
        )
        print(f"[build] {name}: nvcc {nvcc_s:.1f} s, load {wall:.1f} s; "
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


def _rms(cost, npix):
    return np.sqrt(cost / np.maximum(npix, 1.0))


def _agreement(res_k, res_p, pos_slots):
    """Per-lane agreement of two LMResults: max |Δpos|, max cost rel (all
    lanes, and lanes above RMS_FLOOR), the lanes at the floor and their
    max |Δrms|, and the equal shares of converged / npix / n_iter; raises
    on a lane outside the bounds (module constants)."""
    xk, xp = res_k.x.cpu().numpy(), res_p.x.cpu().numpy()
    ck, cp = res_k.cost.cpu().numpy(), res_p.cost.cpu().numpy()
    nk, npx = res_k.npix.cpu().numpy(), res_p.npix.cpu().numpy()
    pos_err = np.abs(xk[:, pos_slots] - xp[:, pos_slots])
    cost_rel = np.abs(ck - cp) / np.maximum(np.abs(cp), 1e-30)
    rk, rp = _rms(ck, nk), _rms(cp, npx)
    drms = np.abs(rk - rp)
    floor = (rk < RMS_FLOOR) & (rp < RMS_FLOOR)
    a = dict(
        pos=float(pos_err.max()), cost_rel=float(cost_rel.max()),
        cost_rel_above_floor=float(cost_rel[~floor].max(initial=0.0)),
        drms=float(drms[floor].max(initial=0.0)),
        floor_lanes=int(floor.sum()),
        conv=float(np.mean(res_k.converged.cpu().numpy()
                           == res_p.converged.cpu().numpy())),
        npix=float(np.mean(nk == npx)),
        iters=float(np.mean(res_k.n_iter.cpu().numpy()
                            == res_p.n_iter.cpu().numpy())),
        bit_equal=float(np.mean((xk == xp).all(axis=1) & (ck == cp))),
    )
    check(np.isfinite(xk).all() and np.isfinite(ck).all(),
          "kernel returned non-finite values")
    check(a["pos"] <= POS_ATOL, f"positions disagree: {a}")
    check(((cost_rel <= COST_RTOL) | floor).all(), f"cost disagrees: {a}")
    check(a["conv"] >= AGREE_FRAC, f"converged flags disagree: {a}")
    check(a["npix"] >= AGREE_FRAC, f"npix disagrees: {a}")
    return a


def _fmt(a):
    return (f"max |dpos| {a['pos']:.3e} px, max cost rel "
            f"{a['cost_rel_above_floor']:.3e} on lanes with rms >= "
            f"{RMS_FLOOR:g} ({a['floor_lanes']} lanes below it in both: max "
            f"cost rel {a['cost_rel']:.3e}, max |drms| {a['drms']:.3e}), "
            f"converged equal "
            f"{a['conv']:.5f}, npix equal {a['npix']:.5f}, n_iter equal "
            f"{a['iters']:.5f}, bit-equal lanes {a['bit_equal']:.5f}")


def _first_round_inputs_3d(batch, device):
    """The gathered route's first-round inputs of config 4."""
    import torch

    from clustertracking_tpu_torch.entry import MODES_3D, RADIUS_3D, WINDOW_3D
    from clustertracking_tpu_torch.interop import from_reference
    from clustertracking_tpu_torch.models import build_layout, get_model
    from clustertracking_tpu_torch.ops.gather import gather_stack, origins_for
    from clustertracking_tpu_torch.refine import _slot_bounds

    model = get_model("gauss")
    layout = build_layout(model, 3, False, 2, dict(MODES_3D))
    st = from_reference(*batch[:5], device=device)
    frame_shape = tuple(st.frames.shape[1:])
    vect0 = layout.vect_from_params(st.params0)
    pos_at = st.params0[..., list(layout.pos_param_idx)].contiguous()
    origin = origins_for(pos_at, WINDOW_3D, frame_shape)
    pixels = gather_stack(st.frames, st.frame_idx, origin, WINDOW_3D)
    norm = torch.clamp(torch.amax(st.params0[..., 1].abs(), dim=1), min=1e-6)
    fvalid = torch.ones((vect0.shape[0], 2), device=device)
    lo, hi = _slot_bounds(layout, WINDOW_3D, frame_shape)
    args = (vect0, st.params0, pixels, pos_at, origin, norm, st.valid,
            fvalid)
    kw = dict(model=model, layout=layout, window_shape=WINDOW_3D, lo=lo,
              hi=hi, radius=RADIUS_3D, max_iter=60)
    return st, args, kw, layout


def phase_kernel3d(batch, device, smi):
    import torch

    from clustertracking_tpu_torch.entry import WINDOW_3D
    from clustertracking_tpu_torch.ops.gather import gather_stack
    from clustertracking_tpu_torch.ops.pixel_lm import (
        pixel_lm, pixel_lm_reference)
    from clustertracking_tpu_torch.ops.window_gather import window_gather

    st, args, kw, layout = _first_round_inputs_3d(batch, device)
    origin = args[4]

    def gk():
        return window_gather(st.frames, st.frame_idx, origin, WINDOW_3D)

    def gp():
        return gather_stack(st.frames, st.frame_idx, origin, WINDOW_3D)

    pix_k, pix_p = gk(), gp()
    torch.cuda.synchronize()
    gather_equal = bool(torch.equal(pix_k, pix_p))
    gather_err = float((pix_k - pix_p).abs().max())
    g_ms, gp_ms = _cuda_ms(gk, 20), _cuda_ms(gp, 20)
    print(f"[kernel3d] {smi}: window_gather vs gather_stack at B={len(pix_k)},"
          f" {WINDOW_3D}: bit-equal {gather_equal} (max |d| {gather_err:.1e}"
          f"); kernel {g_ms:.4f} ms, plain {gp_ms:.4f} ms per call",
          flush=True)
    check(gather_equal, "window_gather differs from gather_stack")

    pos_slots = sorted({int(s) for p in layout.pos_param_idx
                        for s in layout.slot_idx[:, p]})
    res_p = pixel_lm_reference(*args, **kw)
    out = {}
    for mode, streaming in (("resident", False), ("streamed", True)):
        res_k = pixel_lm(*args, **kw, streaming=streaming)
        torch.cuda.synchronize()
        a = _agreement(res_k, res_p, pos_slots)
        ms = _cuda_ms(lambda: pixel_lm(*args, **kw, streaming=streaming), 5)
        out[mode] = dict(res=res_k, agree=a, ms=ms)
    plain_ms = _cuda_ms(lambda: pixel_lm_reference(*args, **kw), 1)
    npix = out["resident"]["res"].npix.cpu().numpy()
    for mode in ("resident", "streamed"):
        print(f"[kernel3d] {smi}: pixel_lm {mode} vs plain at B={len(npix)},"
              f" {WINDOW_3D}: {_fmt(out[mode]['agree'])}; kernel "
              f"{out[mode]['ms']:.3f} ms, plain {plain_ms:.3f} ms per call",
              flush=True)
    a = _agreement(out["streamed"]["res"], out["resident"]["res"], pos_slots)
    print(f"[kernel3d] {smi}: pixel_lm streamed vs resident: {_fmt(a)}; "
          f"mean in-mask npix {npix.mean():.2f} of "
          f"{int(np.prod(WINDOW_3D))} voxels (min {npix.min():.0f}, max "
          f"{npix.max():.0f})", flush=True)
    # The same scene with noise (sigma 1 on signal 150): every fit ends
    # well above float32 resolution, so cost is compared on every lane.
    noisy = batch[0] + np.random.default_rng(5).normal(
        0.0, 1.0, batch[0].shape).astype(np.float32)
    _, args_n, kw_n, _ = _first_round_inputs_3d((noisy,) + batch[1:], device)
    res_pn = pixel_lm_reference(*args_n, **kw_n)
    for mode, streaming in (("resident", False), ("streamed", True)):
        a = _agreement(pixel_lm(*args_n, **kw_n, streaming=streaming),
                       res_pn, pos_slots)
        print(f"[kernel3d] {smi}: pixel_lm {mode} vs plain, scene with "
              f"noise sigma 1: {_fmt(a)}", flush=True)
        check(a["floor_lanes"] == 0, "a noisy lane fit to float32 resolution")
        out[mode]["agree"]["pos"] = max(out[mode]["agree"]["pos"], a["pos"])
    return dict(
        gather=dict(max_abs_err=gather_err, ms=g_ms, plain_ms=gp_ms),
        **{m: dict(max_abs_err=out[m]["agree"]["pos"], ms=out[m]["ms"],
                   plain_ms=plain_ms) for m in out},
    )


def _reset_counts():
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d
    from clustertracking_tpu_torch.ops.pixel_lm import pixel_lm
    from clustertracking_tpu_torch.ops.window_gather import window_gather

    fused_lm_2d.launches = 0
    window_gather.launches = 0
    pixel_lm.launches_resident = 0
    pixel_lm.launches_streamed = 0


def _counts():
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d
    from clustertracking_tpu_torch.ops.pixel_lm import pixel_lm
    from clustertracking_tpu_torch.ops.window_gather import window_gather

    return dict(fused_lm_2d=fused_lm_2d.launches,
                window_gather=window_gather.launches,
                resident=pixel_lm.launches_resident,
                streamed=pixel_lm.launches_streamed)


def phase_main3d(batch, device, smi):
    """Config 4 through the bucket solver twice: pixel_lm's mode as
    streaming=None picks it (by occupancy), then resident forced
    (streaming=False, the reference's make_pallas_lm option).  Returns
    the launch counts of both runs, summed."""
    import torch

    from clustertracking_tpu_torch.entry import entry_3d

    total, outs = {}, {}
    for streaming in (None, False):
        solve, args = entry_3d(device, batch=batch, streaming=streaming)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        params, rms, conv, iters, _ = solve(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = _counts()
        rms = rms.cpu().numpy()
        pos = params[..., 2:5].cpu().numpy()
        med = float(np.median(np.abs(pos - batch[5]).max(axis=-1)))
        print(f"[main3d] {smi}: entry_3d(streaming={streaming}) bucket "
              f"solver, B={len(rms)}, {batch[0].shape[0]} stacks of "
              f"{batch[0].shape[1:]}: launches {n}, {wall:.3f} s, mean rms "
              f"{rms.mean():.3e}, median |pos - truth| {med:.5f} px, "
              f"converged {float(conv.float().mean()):.4f}, mean LM iters "
              f"{float(iters.float().mean()):.2f}", flush=True)
        check(n["window_gather"] > 0,
              "the 3D path did not launch window_gather")
        check(n["resident"] + n["streamed"] > 0,
              "the 3D path did not launch pixel_lm")
        check(streaming is None or n["streamed"] == 0,
              "streaming=False launched the streamed mode")
        check(n["fused_lm_2d"] == 0, "the 3D path launched fused_lm_2d")
        check(np.isfinite(rms).all(), "non-finite rms")
        check(rms.mean() < 0.2, f"mean rms {rms.mean()}")
        check(med < 0.05, f"median position error {med} px")
        total = {k: total.get(k, 0) + v for k, v in n.items()}
        outs[streaming] = pos
    dpos = float(np.abs(outs[None] - outs[False]).max())
    check(dpos <= POS_ATOL, f"the two modes' fits differ by {dpos} px")
    return total


def phase_rates3d(batch, device, smi):
    import torch

    from clustertracking_tpu_torch.entry import (
        WINDOW_3D, entry_3d, example_batch_3d)
    from clustertracking_tpu_torch.ops.pixel_lm import (
        occupancy, pick_streaming)

    solve, args = entry_3d(device, batch=batch)
    plain, _ = entry_3d(device, batch=batch, lm_backend="torch",
                        gather_backend="torch")
    rate_p1, disp_p1 = _rate(plain, args, REPS_PLAIN)
    rate_k1, disp_k1 = _rate(solve, args, REPS_KERNEL)
    rate_k2, disp_k2 = _rate(solve, args, REPS_KERNEL)
    rate_p2, disp_p2 = _rate(plain, args, REPS_PLAIN)
    big = example_batch_3d(B=B_3D_BIG)
    solve_big, args_big = entry_3d(device, batch=big)
    rate_big, disp_big = _rate(solve_big, args_big, REPS_KERNEL // 4)
    occ = occupancy(WINDOW_3D)
    mode = "streamed" if pick_streaming(occ) else "resident"
    warps = occ[mode]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[rates3d] {smi}: config 4 bucket solver clusters/s — B={B_3D}: "
          f"gathered {rate_k1:.1f} (disp {disp_k1:.3f}), {rate_k2:.1f} "
          f"(disp {disp_k2:.3f}); plain {rate_p1:.1f} (disp {disp_p1:.3f}), "
          f"{rate_p2:.1f} (disp {disp_p2:.3f}); B={B_3D_BIG} "
          f"({big[0].nbytes / 1e6:.0f} MB of stacks): gathered "
          f"{rate_big:.1f} (disp {disp_big:.3f}); pixel_lm occupancy "
          f"{occ['resident']} warps/SM resident, {occ['streamed']} "
          f"streamed, so it runs {mode}: on {sms} SMs {B_3D} clusters fill "
          f"{B_3D / (warps * sms):.2f} waves and {B_3D_BIG} fill "
          f"{B_3D_BIG / (warps * sms):.2f}", flush=True)
    return big, solve_big, args_big


def _device_ms(prof):
    """Device time by kernel name in a torch.profiler run, in ms, leaving
    out the record_function ranges (device spans too)."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and not e.key.startswith(("refit_round", "fit_bucket")):
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


def phase_profile3d(solve, args, smi):
    import torch
    from torch.profiler import ProfilerActivity, profile

    reps = 4
    solve(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solve(*args)
    out[1].cpu()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            out = solve(*args)
        out[1].cpu()
    dev = {k: v / reps for k, v in _device_ms(prof).items()}
    gather = sum(v for k, v in dev.items() if "window_gather" in k)
    lm = sum(v for k, v in dev.items() if "pixel_lm" in k)
    others = sorted(((v, k) for k, v in dev.items()
                     if "window_gather" not in k and "pixel_lm" not in k),
                    reverse=True)
    rest = sum(v for v, _ in others)
    busy = gather + lm + rest
    top = others[:3]
    print(f"[profile3d] {smi}: config 4 at B={len(args[4])}, per solve: "
          f"wall {wall:.3f} ms (unprofiled); device window_gather "
          f"{gather:.3f} ms, pixel_lm {lm:.3f} ms, {len(others)} other "
          f"kernels/copies {rest:.3f} ms (top: "
          + "; ".join(f"{k[:40]} {v:.3f}" for v, k in top)
          + f"); device idle share {1.0 - busy / wall:.3f}", flush=True)
    check(gather > 0 and lm > 0, "the profile saw no gathered-route kernel")


def phase_stream2d(device, smi):
    import torch

    from clustertracking_tpu_torch.entry import RADIUS, example_batch
    from clustertracking_tpu_torch.interop import from_reference
    from clustertracking_tpu_torch.models import get_model
    from clustertracking_tpu_torch.ops.fused_lm import kernel_route
    from clustertracking_tpu_torch.refine import _bucket_solver

    batch = example_batch(B=B_3D, frame_size=FRAME, grid_pitch=PITCH,
                          with_truth=True)
    st = from_reference(*batch[:5], device=device)
    args = (st.frames, st.frame_idx, st.params0, st.pose0, st.valid)
    common = (get_model("gauss"), 2, True, 2, (), STREAM_WINDOW,
              STREAM_RADIUS, (), None, 1e5, 10, 1.0, 60, 1.49e-8, 1.49e-8,
              False)
    kernel_route_solve, layout = _bucket_solver(*common, "auto", "auto")
    plain, _ = _bucket_solver(*common, "torch", "torch")
    route = kernel_route(get_model("gauss"), layout, False, None,
                         STREAM_WINDOW)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    pk, rk, ck, ik, _ = kernel_route_solve(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts()
    t0 = time.perf_counter()
    pp, rp, cp, ip, _ = plain(*args)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    pos_err = float(np.abs(pk[..., 2:4].cpu().numpy()
                           - pp[..., 2:4].cpu().numpy()).max())
    rk, rp = rk.cpu().numpy(), rp.cpu().numpy()
    # cost = npix·rms², so COST_RTOL on cost is COST_RTOL / 2 on rms
    rms_ok = (np.abs(rk - rp) <= 0.5 * COST_RTOL * rp) | (
        (rk < RMS_FLOOR) & (rp < RMS_FLOOR))
    conv_eq = float(np.mean(ck.cpu().numpy() == cp.cpu().numpy()))
    err = np.abs(pk[..., 2:4].cpu().numpy() - batch[5]).max(axis=-1)
    print(f"[stream2d] {smi}: entry scene B={B_3D}, window {STREAM_WINDOW},"
          f" radius {STREAM_RADIUS}: route {route!r}, launches {n}; "
          f"gathered {wall:.3f} s vs plain {wall_p:.3f} s; max |dpos| "
          f"{pos_err:.3e} px, max rms rel "
          f"{float(np.max(np.abs(rk - rp) / rp)):.3e}, converged equal "
          f"{conv_eq:.5f}; median |pos - truth| {np.median(err):.4f} px",
          flush=True)
    check(route == "gathered", f"a {STREAM_WINDOW} window routed {route}")
    check(n["streamed"] > 0 and n["resident"] == 0 and n["fused_lm_2d"] == 0
          and n["window_gather"] > 0, f"stream2d took other kernels: {n}")
    check(pos_err <= POS_ATOL, "streamed route positions disagree")
    check(rms_ok.all(), "streamed route rms disagrees")
    check(conv_eq >= AGREE_FRAC, "streamed route converged flags disagree")
    return n


def phase_refine3d(batch, device, smi):
    try:
        import pandas as pd
    except ImportError:
        print("[refine3d] pandas is not installed: refine_leastsq phase "
              "not run", flush=True)
        return
    from clustertracking_tpu_torch import diagnostics, refine_leastsq

    frames, fidx, params0, truth = batch[0], batch[1], batch[2], batch[5]
    B, n = params0.shape[:2]
    f = pd.DataFrame({
        "frame": np.repeat(fidx, n),
        "z": params0[:, :, 2].ravel().astype(float),
        "y": params0[:, :, 3].ravel().astype(float),
        "x": params0[:, :, 4].ravel().astype(float),
        "signal": 150.0,
        "size_z": 1.5, "size_y": 2.2, "size_x": 2.2,
    })
    _reset_counts()
    t0 = time.perf_counter()
    with diagnostics.collect() as stats:
        out = refine_leastsq(
            f, frames, diameter=(7, 9, 9), separation=5.0, device=device,
            param_mode={"size_z": "var", "size_y": "var", "size_x": "var"})
    wall = time.perf_counter() - t0
    launches = _counts()
    cost = out["cost"].to_numpy()
    err = np.abs(out[["z", "y", "x"]].to_numpy() - truth.reshape(-1, 3))
    med = float(np.median(err.max(axis=1)))
    routes = sorted({b.backend for b in stats.batches})
    print(f"[refine3d] {smi}: refine_leastsq on {len(f)} rows / "
          f"{len(np.unique(fidx))} stacks: {wall:.2f} s, "
          f"{len(stats.batches)} dispatches {routes}, cluster sizes "
          f"{sorted({int(s) for s in out['cluster_size']})}, launches "
          f"{launches}, accepted {np.isfinite(cost).mean():.4f}, mean cost "
          f"{np.nanmean(cost):.3e}, median |pos - truth| {med:.5f} px",
          flush=True)
    check(np.isfinite(cost).all(), "refine_leastsq rejected 3D fits")
    check(routes == ["cuda-gathered"], f"3D dispatches took {routes}")
    check(launches["resident"] + launches["streamed"] > 0,
          "refine_leastsq bypassed pixel_lm")
    check(med < 0.05, f"refine_leastsq 3D median position error {med} px")
    return launches


def main():
    smi = phase_device()
    import torch

    from clustertracking_tpu_torch.entry import example_batch, example_batch_3d

    device = "cuda"
    phase_build()
    batch = example_batch(B=B_FULL, frame_size=FRAME, grid_pitch=PITCH,
                          with_truth=True)
    k = phase_kernel(batch, device, smi)
    launches = phase_main(batch, device, smi)
    phase_rates(batch, device, smi)
    phase_refine(batch, device, smi)
    del batch
    batch3d = example_batch_3d(B=B_3D, with_truth=True)
    k3 = phase_kernel3d(batch3d, device, smi)
    n3 = phase_main3d(batch3d, device, smi)
    _, solve_big, args_big = phase_rates3d(batch3d, device, smi)
    phase_profile3d(solve_big, args_big, smi)
    del solve_big, args_big
    torch.cuda.empty_cache()
    n2 = phase_stream2d(device, smi)
    r3 = phase_refine3d(batch3d, device, smi)
    # launches of the gathered route's kernels over the paths that drive it
    n3 = {nm: n3[nm] + n2[nm] + (r3 or {}).get(nm, 0) for nm in n3}
    for name in ("window_gather", "resident", "streamed"):
        check(n3[name] > 0, f"no path of the 3D slice launched {name}")
    src = "clustertracking_tpu_torch/csrc/"
    print(json.dumps({"kernels": [{
        "name": "fused_lm_2d",
        "route": "cuda",
        "source": src + "fused_lm_2d.cu",
        "replaces": "clustertracking_tpu/ops/pallas_lm.py:1213",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }, {
        "name": "window_gather",
        "route": "cuda",
        "source": src + "window_gather.cu",
        "replaces": "clustertracking_tpu/ops/pallas_gather.py:144",
        "launches": n3["window_gather"],
        **k3["gather"],
    }, {
        "name": "pixel_lm (resident)",
        "route": "cuda",
        "source": src + "pixel_lm.cu",
        "replaces": "clustertracking_tpu/ops/pallas_lm.py:1143",
        "launches": n3["resident"],
        **k3["resident"],
    }, {
        "name": "pixel_lm (streamed)",
        "route": "cuda",
        "source": src + "pixel_lm.cu",
        "replaces": "clustertracking_tpu/ops/pallas_lm.py:1161",
        "launches": n3["streamed"],
        **k3["streamed"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
