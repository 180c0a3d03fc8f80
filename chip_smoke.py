#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --gauss-kernels DIR   # gauss kernels of DIR's port

Drives the port (``clustertracking_tpu_torch``; no JAX) through its main
paths, the bucketed cluster fit, at the reference's own sizes: 16,384
two-Gaussian dimers on 64 frames of 256×256 in 13×13 windows (bench.py's
configuration), config 4 of benchmarks/suite.py, 2,048 anisotropic 3D
dimers in 8 z-stacks of 64×192×192 in 9×13×13 windows, and the rigid
cells, configs 3 (4,096 dimers, 4,096 trimers), 3b and 3c (2,048 3D
dimers, 2,048 tetramers).  Phases, one line or more each:

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
12. refine3d — refine_leastsq on config 4's scene as a DataFrame;
13. profiles — ring, hat, disc, inv_series_2: fused_lm_2d and pixel_lm
              (both modes) against their plain versions, timed beside
              gauss on the same scenes; then refine_leastsq in 2D and 3D
              and the 3D bucket solver per mode, with launch counts;
14. kernel_rigid — each rigid instantiation (2D n-gon; 3D axis and
              rotation vector, both modes) against its plain version on
              its cell's first round, noise-free and with noise σ=1;
15. rigid   — configs 3, 3b, 3c through entry_rigid: launch counts,
              accuracy, bond lengths, kernel and plain route clusters/s,
              and a torch.profiler breakdown;
16. refine_rigid — refine_leastsq(constraints=...) per pose kind against
              lm_backend='torch', and a generic constraint dict.

A [time] line follows each phase.  Then one JSON line describing each
kernel (with its bound: the larger of its FP32 operations over the card's
peak and its bytes over the memory rate), and last the contract line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the contract line is not printed.
"""
import json
import re
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
# The rigid cells' geometry: bond lengths and edges as exact as float32
# positions of a few hundred px allow (2D and 3D dimers, trimers), and the
# tetramer's edges through the rotation vector to 1e-3 px.
BOND_ATOL = 1e-4
TETRA_ATOL = 1e-3
RIGID_BLOCKS = 3      # timed blocks per rigid rate
RIGID_REPS_KERNEL = 8
RIGID_REPS_PLAIN = 1
# The non-gauss profiles: param modes, the feature drawn (inv_series_2
# approximates the gauss it is drawn with) and its kwargs, the extras'
# starts (off their true values).
PROFILE_CASES = {
    "ring": ({}, "ring", dict(thickness=0.25), [0.22]),
    "hat": ({}, "hat", dict(disc_size=0.4), [0.45]),
    "disc": ({}, "disc", {}, []),
    "inv_series_2": ({"coeff_1": "var", "coeff_2": "var"}, "gauss", {},
                     [0.55, 0.1]),
}
B_PROFILE_2D = 2048
B_PROFILE_3D = 1024
# bound_ms: the least time an NVIDIA H100 SXM could take (NVIDIA's data
# sheet, at its 700 W limit): float32 outside the tensor cores, and the
# device memory rate.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
# FP32 operations per in-mask pixel and feature of one Jacobian sweep,
# counted from csrc/lm_core.cuh (pixel_row, profile, profile_dextra;
# expf, sqrtf and a division count one each): the profile's value and
# dI/dr², and each extra parameter's Jacobian row.
_PROFILE_OPS = {0: 3, 1: 13, 2: 15, 3: 12}
_DEXTRA_OPS = {1: 10, 2: 17}
# a pose's chain rule per feature: fixed distance, and what a fitted one
# adds (pose kinds of lm_core.cuh: none, 2D n-gon, 3D axis, 3D rotation)
_POSE_OPS = {0: (0, 0), 1: (7, 5), 2: (13, 7), 3: (24, 7)}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _pixel_ops(n, D, V, iso, prof, nx, pose, fit_dist):
    """FP32 operations per in-mask pixel of one sweep of the LM core: the
    model and Jacobian row of each feature, then the cost, g and upper H
    sums (a product and an add each)."""
    feat = 4 * D + 6 + 5 * D + (5 if iso else 5 * D)
    if prof == 4:   # inv_series: k coefficients
        feat += 7 * nx + 4 + sum(k + 7 for k in range(nx))
    else:
        feat += _PROFILE_OPS[prof] + _DEXTRA_OPS.get(prof, 0)
    fixed, dist = _POSE_OPS[pose]
    feat += fixed + dist * fit_dist
    return n * feat + 4 + 2 * (1 + V + V * (V + 1) // 2)


def _bound(nbytes, ops):
    """bound_ms and bound_by of a launch that must move ``nbytes`` and do
    ``ops`` float32 operations."""
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _lm_bound(res, args, kw):
    """The bound of one LM launch (``fused_lm_2d`` or ``pixel_lm``
    arguments; the frames or pixels third) from this run's data: every
    valid lane's in-mask pixels (npix) times its sweeps (n_iter + 1), the
    damped Cholesky of each iteration, and the bytes of each lane's window
    read once, its other inputs and its outputs."""
    from clustertracking_tpu_torch.ops.pixel_lm import pose_kind, profile_tag
    from clustertracking_tpu_torch.ops.rigid import rigid_kernel_slots

    model, layout, con = kw["model"], kw["layout"], kw.get("constraint")
    V = (layout.n_slots if con is None
         else len(rigid_kernel_slots(layout, con)[1]))
    per_pixel = _pixel_ops(
        layout.n_features, layout.ndim, V, layout.isotropic,
        profile_tag(model), len(model.extra_params), pose_kind(layout, con),
        int(con is not None and con.fit_dist))
    iters = res.n_iter.double().cpu().numpy()
    npix = res.npix.double().cpu().numpy()
    sweeps = np.where(npix > 0, iters + 1, 0)
    ops = (per_pixel * float((npix * sweeps).sum())
           + (V ** 3 / 3 + 2 * V * V) * float(iters[npix > 0].sum()))
    B = len(iters)
    window = 4 * B * int(np.prod(kw["window_shape"]))
    lanes = sum(a.nbytes for i, a in enumerate(args)
                if i != 2 and a is not None)
    return _bound(window + lanes + B * (4 * V + 16), ops)


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
        # registers by instantiation: its template arguments (D, streamed,
        # profile, pose), in the order nvcc reports them
        regs = " ".join(
            ",".join(re.findall(r"L[ib](\d+)", e.split("_kernel", 1)[1]
                                .split("EEEv")[0])) + f"={r}"
            for e, r in _ptxas_registers(report))
        spills = [line.strip() for line in report.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"[build] {name}: nvcc {nvcc_s:.1f} s, load {wall:.1f} s; "
              f"registers {regs or 'cached build'}; spilling: "
              f"{spills or 'none'}", flush=True)


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
    bound = _lm_bound(res_k, args, kw)
    print(f"[kernel] {smi}: fused_lm_2d bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}; mean in-mask npix "
          f"{float(res_k.npix.mean()):.2f}, mean LM iters "
          f"{float(res_k.n_iter.float().mean()):.2f})", flush=True)
    return dict(max_abs_err=float(pos_err.max()), ms=ms, plain_ms=plain_ms,
                **bound, library_ms=None)


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


def _rate(solve, args, reps_per_block, blocks=BLOCKS):
    """bench.py's method: a distinct perturbed initial guess per rep (made
    on the device; a rigid bucket's pose too), each block fenced by a
    device→host copy of its last output, the median block rate with its
    dispersion."""
    import torch

    frames, fidx, params0, pose0, valid = args
    gen = torch.Generator(device=params0.device).manual_seed(1)

    def jitter(t):
        return t + (torch.rand(t.shape, generator=gen, device=t.device)
                    * 0.1 - 0.05)

    reps = [(jitter(params0), jitter(pose0))
            for _ in range((blocks + 1) * reps_per_block)]
    torch.cuda.synchronize()

    def block(k):
        t0 = time.perf_counter()
        outs = [solve(frames, fidx, p, q, valid)
                for p, q in reps[k * reps_per_block:(k + 1) * reps_per_block]]
        outs[-1][1].cpu()
        return len(valid) * reps_per_block / (time.perf_counter() - t0), outs

    block(0)  # warm-up block
    rates, outs = [], None
    for k in range(1, blocks + 1):
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
    on a lane outside the bounds (module constants).  ``pos_slots``: the
    position columns of x, or a callable giving positions [B, ...] from
    x (a rigid bucket's pose)."""
    xk, xp = res_k.x.cpu().numpy(), res_p.x.cpu().numpy()
    ck, cp = res_k.cost.cpu().numpy(), res_p.cost.cpu().numpy()
    nk, npx = res_k.npix.cpu().numpy(), res_p.npix.cpu().numpy()
    if callable(pos_slots):
        pos_err = np.abs(pos_slots(res_k.x) - pos_slots(res_p.x))
    else:
        pos_err = np.abs(xk[:, pos_slots] - xp[:, pos_slots])
    cost_rel = np.abs(ck - cp) / np.maximum(np.abs(cp), 1e-30)
    rk, rp = _rms(ck, nk), _rms(cp, npx)
    drms = np.abs(rk - rp)
    floor = (rk < RMS_FLOOR) & (rp < RMS_FLOOR)
    conv_eq = res_k.converged.cpu().numpy() == res_p.converged.cpu().numpy()
    a = dict(
        pos=float(pos_err.max()), cost_rel=float(cost_rel.max()),
        cost_rel_above_floor=float(cost_rel[~floor].max(initial=0.0)),
        drms=float(drms[floor].max(initial=0.0)),
        floor_lanes=int(floor.sum()),
        # at the floor the ftol/xtol tests fire on rounding noise, so the
        # flags are held equal on the lanes above it (every lane of a
        # noisy scene)
        conv=float(conv_eq[~floor].mean()) if (~floor).any() else 1.0,
        conv_all=float(conv_eq.mean()),
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
            f"converged equal {a['conv']:.5f} above it ({a['conv_all']:.5f} "
            f"on all lanes), npix equal {a['npix']:.5f}, n_iter equal "
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
    # the gather reads each window once and writes it once; gather_stack,
    # one advanced-index read, is the one PyTorch call that computes it
    g_bytes = 2 * pix_k.nbytes + origin.nbytes + st.frame_idx.nbytes
    bounds = {m: _lm_bound(out[m]["res"], args, kw) for m in out}
    print(f"[kernel3d] {smi}: bounds — window_gather "
          f"{_bound(g_bytes, 0)['bound_ms']:.4f} ms (bytes), pixel_lm "
          + ", ".join(f"{m} {b['bound_ms']:.4f} ms ({b['bound_by']})"
                      for m, b in bounds.items()), flush=True)
    return dict(
        gather=dict(max_abs_err=gather_err, ms=g_ms, plain_ms=gp_ms,
                    **_bound(g_bytes, 0), library_ms=gp_ms),
        **{m: dict(max_abs_err=out[m]["agree"]["pos"], ms=out[m]["ms"],
                   plain_ms=plain_ms, **bounds[m], library_ms=None)
           for m in out},
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


def _profile(solve, args, reps=4):
    """(unprofiled wall ms per solve, device ms per solve by kernel name)
    of ``reps`` solves, each run fenced by a device→host copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    return wall, {k: v / reps for k, v in _device_ms(prof).items()}


def phase_profile3d(solve, args, smi):
    wall, dev = _profile(solve, args)
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


def _round_inputs(model, layout, batch, window, radius, device, gathered,
                  constraint=None):
    """A bucket's first refit round as ``_bucket_solver`` hands it to a
    kernel: (args, kw) of ``fused_lm_2d`` (frames) or, ``gathered``,
    ``pixel_lm`` (the windows gathered).  A rigid ``constraint`` puts the
    pose (batch[3]) before the slots and takes positions from it."""
    import torch

    from clustertracking_tpu_torch.constraints import pose_to_positions
    from clustertracking_tpu_torch.interop import from_reference
    from clustertracking_tpu_torch.ops.gather import gather_stack, origins_for
    from clustertracking_tpu_torch.refine import _slot_bounds

    st = from_reference(*batch[:5], device=device)
    frame_shape = tuple(st.frames.shape[1:])
    vect0 = layout.vect_from_params(st.params0)
    if constraint is None:
        pos_at = st.params0[..., list(layout.pos_param_idx)].contiguous()
    else:
        vect0 = torch.cat([st.pose0, vect0], dim=1)
        pos_at = pose_to_positions(st.pose0, constraint).contiguous()
    origin = origins_for(pos_at, window, frame_shape)
    norm = torch.clamp(torch.amax(st.params0[..., 1].abs(), dim=1), min=1e-6)
    fvalid = torch.ones(pos_at.shape[:2], device=device)
    lo, hi = _slot_bounds(layout, window, frame_shape, constraint=constraint)
    src = ((gather_stack(st.frames, st.frame_idx, origin, window),)
           if gathered else (st.frames, st.frame_idx))
    args = (vect0, st.params0, *src, pos_at, origin, norm, st.valid, fvalid)
    kw = dict(model=model, layout=layout, window_shape=window, lo=lo, hi=hi,
              radius=radius, max_iter=60, constraint=constraint)
    return args, kw


def _launcher(route):
    """The kernel wrapper of a route: fused_lm_2d, or pixel_lm in a mode."""
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d
    from clustertracking_tpu_torch.ops.pixel_lm import pixel_lm

    if route == "fused":
        return lambda args, kw: fused_lm_2d(*args, **kw)
    return lambda args, kw: pixel_lm(*args, **kw,
                                     streaming=route == "streamed")


def _plain(route):
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d_reference
    from clustertracking_tpu_torch.ops.pixel_lm import pixel_lm_reference

    ref = fused_lm_2d_reference if route == "fused" else pixel_lm_reference
    return lambda args, kw: ref(*args, **kw)


def _timed(fn):
    """(result, ms) of one call of ``fn`` on the device, by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def _launched(counts, route):
    return counts["fused_lm_2d"] if route == "fused" else counts[route]


def _profile_scene(name, ndim, B, seed=21):
    """Dimers drawn with a profile (PROFILE_CASES), one per 16-px cell of
    256×256 frames (2D) or 48×96×96 stacks (3D): separation 4, size 1.8
    (2D) or 1.5 (3D), signal 100, noise σ=0.5, starts ±0.2 px off the
    truth and the extras off their true values.  Returns the five solver
    arrays plus the truth [B, 2, D], the layout and the window."""
    from clustertracking_tpu_torch import artificial
    from clustertracking_tpu_torch.models import build_layout, get_model

    modes, feat, feat_kw, start = PROFILE_CASES.get(name, ({}, name, {}, []))
    layout = build_layout(get_model(name), ndim, True, 2, modes)
    rng = np.random.default_rng(seed)
    shape = (256, 256) if ndim == 2 else (48, 96, 96)
    size = 1.8 if ndim == 2 else 1.5
    per = tuple(s // 16 for s in shape)
    per_frame = int(np.prod(per))
    T = -(-B // per_frame)
    frames = np.zeros((T,) + shape, np.float32)
    params0 = np.zeros((B, 2, layout.n_params), np.float32)
    truth = np.zeros((B, 2, ndim))
    fidx = np.zeros(B, np.int32)
    for b in range(B):
        t, cell = b // per_frame, b % per_frame
        center = (np.array(np.unravel_index(cell, per), float) * 16 + 8
                  + rng.uniform(-1, 1, ndim))
        truth[b] = artificial.draw_cluster(
            frames[t], center, size=size, separation=4.0, n=2, signal=100.0,
            angle=rng.uniform(0, np.pi), feat_func=feat, **feat_kw)
        params0[b, :, 1] = 100.0
        params0[b, :, 2:2 + ndim] = truth[b] + rng.uniform(-0.2, 0.2,
                                                           (2, ndim))
        params0[b, :, 2 + ndim] = size
        params0[b, :, 3 + ndim:] = start
        fidx[b] = t
    frames += np.random.default_rng(seed + 1).normal(
        0.0, 0.5, frames.shape).astype(np.float32)
    batch = (frames, fidx, params0, np.zeros((B, 0), np.float32),
             np.ones(B, bool), truth)
    window = (9, 9) if ndim == 2 else (7, 9, 9)
    return batch, layout, window, size


def _scene_frame(batch, ndim):
    """A solver batch as refine_leastsq's DataFrame (the starts)."""
    import pandas as pd

    frames, fidx, params0 = batch[:3]
    n = params0.shape[1]
    cols = ["z", "y", "x"][3 - ndim:]
    f = pd.DataFrame(params0[:, :, 2:2 + ndim].reshape(-1, ndim)
                     .astype(float), columns=cols)
    f["frame"] = np.repeat(fidx, n)
    f["signal"] = params0[:, :, 1].ravel().astype(float)
    return f, cols


def phase_profiles(device, smi):
    """Each non-gauss profile: fused_lm_2d (2D) and pixel_lm resident and
    streamed (3D) vs their plain versions on a noisy scene's first-round
    inputs, timed; then its main path with the launch counts:
    refine_leastsq(fit_function=...) in 2D and 3D, and the 3D bucket
    solver with each pixel_lm mode forced."""
    import torch

    from clustertracking_tpu_torch import diagnostics, refine_leastsq
    from clustertracking_tpu_torch.models import get_model
    from clustertracking_tpu_torch.refine import _bucket_solver

    out, launches = {}, {}
    # the gauss kernels on the same geometry, the yardstick of the others
    ms = {}
    for ndim, B in ((2, B_PROFILE_2D), (3, B_PROFILE_3D)):
        batch, layout, window, _ = _profile_scene("gauss", ndim, B)
        args, kw = _round_inputs(get_model("gauss"), layout, batch, window,
                                 (3.0,) * ndim, device, gathered=ndim == 3)
        for route in (("fused",) if ndim == 2 else ("resident", "streamed")):
            call = _launcher(route)
            ms[route] = _cuda_ms(lambda: call(args, kw), 5)
    print(f"[profiles] {smi}: gauss on the same scenes: fused "
          f"{ms['fused']:.3f} ms (B={B_PROFILE_2D}), resident "
          f"{ms['resident']:.3f} ms, streamed {ms['streamed']:.3f} ms "
          f"(B={B_PROFILE_3D})", flush=True)
    for name, (modes, _, _, _) in PROFILE_CASES.items():
        model = get_model(name)
        scenes = {}
        for ndim, B in ((2, B_PROFILE_2D), (3, B_PROFILE_3D)):
            batch, layout, window, size = _profile_scene(name, ndim, B)
            scenes[ndim] = (batch, window, size)
            radius = (3.0,) * ndim
            routes = ("fused",) if ndim == 2 else ("resident", "streamed")
            args, kw = _round_inputs(model, layout, batch, window, radius,
                                     device, gathered=ndim == 3)
            plain = _plain(routes[0])
            res_p, plain_ms = _timed(lambda: plain(args, kw))
            pos_slots = sorted({int(s) for p in layout.pos_param_idx
                                for s in layout.slot_idx[:, p]})
            for route in routes:
                call = _launcher(route)
                res_k = call(args, kw)
                torch.cuda.synchronize()
                a = _agreement(res_k, res_p, pos_slots)
                check(a["floor_lanes"] == 0, "a noisy lane fit to float32 "
                      "resolution")
                ms = _cuda_ms(lambda: call(args, kw), 5)
                bound = _lm_bound(res_k, args, kw)
                print(f"[profiles] {smi}: {name} {route} vs plain at B={B}, "
                      f"{window}: {_fmt(a)}; kernel {ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
                      f"({bound['bound_by']})", flush=True)
                out[(name, route)] = dict(max_abs_err=a["pos"], ms=ms,
                                          plain_ms=plain_ms, **bound,
                                          library_ms=None)
        # the main path: refine_leastsq, then (3D) each mode forced
        torch.cuda.synchronize()
        _reset_counts()
        for ndim, (batch, window, size) in scenes.items():
            radius = (3.0,) * ndim
            f, cols = _scene_frame(batch, ndim)
            before = _counts()
            t0 = time.perf_counter()
            with diagnostics.collect() as stats:
                res = refine_leastsq(
                    f, batch[0], diameter=6.0, separation=6.0,
                    fit_function=name, param_mode=modes,
                    param_val={"size": size}, device=device)
            wall = time.perf_counter() - t0
            cost = res["cost"].to_numpy()
            err = np.abs(res[cols].to_numpy().reshape(batch[5].shape)
                         - batch[5]).max(axis=-1)
            routes_seen = sorted({b.backend for b in stats.batches})
            after = _counts()
            print(f"[profiles] {smi}: {name} refine_leastsq {ndim}D on "
                  f"{len(f)} rows: {wall:.2f} s, {routes_seen}, launches "
                  f"{ {k: after[k] - before[k] for k in after} }, accepted "
                  f"{np.isfinite(cost).mean():.4f}, median |pos - truth| "
                  f"{np.median(err):.4f} px", flush=True)
            want = "cuda-fused" if ndim == 2 else "cuda-gathered"
            check(routes_seen == [want], f"{name} {ndim}D took {routes_seen}")
            check(np.isfinite(cost).all(), f"{name} {ndim}D rejected fits")
            check(np.median(err) < 0.1, f"{name} {ndim}D median position "
                  f"error {np.median(err)} px")
            if ndim == 3:
                st = [torch.as_tensor(a, device=device) for a in batch[:5]]
                for streaming in (False, True):
                    solve, _ = _bucket_solver(
                        model, 3, True, 2, tuple(sorted(modes.items())),
                        window, radius, (), None, 1e5, 10, 1.0, 60, 1.49e-8,
                        1.49e-8, False, "auto", "auto", streaming)
                    _, rms, _, _, _ = solve(*st)
                    rms = rms.cpu().numpy()
                    check(np.isfinite(rms).all() and rms.mean() < 0.1,
                          f"{name} 3D bucket solver rms {rms.mean()}")
        counts = _counts()
        for route in ("fused", "resident", "streamed"):
            launches[(name, route)] = _launched(counts, route)
            check(launches[(name, route)] > 0,
                  f"the {name} path launched no {route} kernel")
    return out, launches


def _rigid_positions(layout, con):
    """x → the positions of a rigid bucket's pose, [B, n·D] numpy."""
    from clustertracking_tpu_torch.ops.rigid import rigid_kernel_slots

    from clustertracking_tpu_torch.constraints import pose_to_positions

    Qt = rigid_kernel_slots(layout, con)[0]
    return lambda x: pose_to_positions(x[:, :Qt], con).reshape(
        len(x), -1).cpu().numpy()


RIGID_ROUTES = {"3-dimer": ("fused",), "3-trimer": ("fused",),
                "3b": ("resident", "streamed"),
                "3c": ("resident", "streamed")}


def _rigid_layout(config):
    from clustertracking_tpu_torch.entry import _rigid_configs
    from clustertracking_tpu_torch.models import build_layout, get_model

    c = _rigid_configs()[config]
    return c, build_layout(get_model("gauss"), c["ndim"], True,
                           c["con"].cluster_size, {})


def phase_kernel_rigid(batches, device, smi):
    """Each rigid kernel instantiation vs its plain version on its cell's
    first-round inputs (noise-free: cost compared where rms >= RMS_FLOOR),
    then on the same scene with noise σ=1 (cost on every lane), timed."""
    import torch

    from clustertracking_tpu_torch.models import get_model

    out = {}
    for config, routes in RIGID_ROUTES.items():
        c, layout = _rigid_layout(config)
        con, batch = c["con"], batches[config]
        noisy = (batch[0] + np.random.default_rng(5).normal(
            0.0, 1.0, batch[0].shape).astype(np.float32),) + batch[1:]
        gathered = c["ndim"] == 3
        ins = [_round_inputs(get_model("gauss"), layout, b, c["window"],
                             c["radius"], device, gathered, con)
               for b in (batch, noisy)]
        plain = _plain(routes[0])
        (res_p, plain_ms), (res_pn, _) = (_timed(lambda: plain(*i))
                                          for i in ins)
        res_p = [res_p, res_pn]
        posf = _rigid_positions(layout, con)
        for route in routes:
            call = _launcher(route)
            res_k = call(*ins[0])
            torch.cuda.synchronize()
            a = _agreement(res_k, res_p[0], posf)
            a_n = _agreement(call(*ins[1]), res_p[1], posf)
            check(a_n["floor_lanes"] == 0, "a noisy lane fit to float32 "
                  "resolution")
            ms = _cuda_ms(lambda: call(*ins[0]), 5)
            bound = _lm_bound(res_k, *ins[0])
            B = len(res_k.cost)
            print(f"[kernel_rigid] {smi}: config {config} {route} vs plain at "
                  f"B={B}, {c['window']}: {_fmt(a)}; with noise σ=1: "
                  f"{_fmt(a_n)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
                  f"mean in-mask npix {float(res_k.npix.mean()):.2f}, mean "
                  f"LM iters {float(res_k.n_iter.float().mean()):.2f}",
                  flush=True)
            out[(config, route)] = dict(max_abs_err=max(a["pos"], a_n["pos"]),
                                        ms=ms, plain_ms=plain_ms, **bound,
                                        library_ms=None)
    return out


def _edges(pos):
    """Pairwise distances [B, n(n−1)] of positions [B, n, D]."""
    d = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
    n = pos.shape[1]
    return d[:, ~np.eye(n, dtype=bool)]


def _bond_check(pos, con, what):
    """Bond lengths exact (fixed distance) or rigid within each cluster
    (fitted); returns the largest deviation."""
    e = _edges(pos)
    if con.dist is None:
        dev = float(np.ptp(e, axis=1).max())
    else:
        dev = float(np.abs(e - con.dist).max())
    tol = TETRA_ATOL if con.cluster_size == 4 else BOND_ATOL
    check(dev <= tol, f"{what}: bond lengths off by {dev} px (tol {tol})")
    return dev


def phase_rigid(batches, device, smi):
    """Configs 3 (dimers, trimers), 3b and 3c through entry_rigid: the
    kernel route once per kernel (3D: each pixel_lm mode forced), with
    its launch counts and the accuracy gates; then clusters/s of the
    kernel route (pixel_lm's mode by occupancy) and of the plain route,
    in turns (plain, kernel, kernel, plain)."""
    import torch

    from clustertracking_tpu_torch.entry import entry_rigid

    launches = {"window_gather": 0}
    for config, routes in RIGID_ROUTES.items():
        c, _ = _rigid_layout(config)
        con, batch, D = c["con"], batches[config], c["ndim"]
        for route in routes:
            streaming = None if route == "fused" else route == "streamed"
            solve, args = entry_rigid(config, device, batch=batch,
                                      streaming=streaming)
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            params, rms, conv, iters, _ = solve(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = _counts()
            rms = rms.cpu().numpy()
            pos = params[..., 2:2 + D].cpu().numpy()
            med = float(np.median(np.abs(pos - batch[5]).max(axis=-1)))
            bond = _bond_check(pos, con, f"config {config} {route}")
            conv_frac = float(conv.float().mean())
            print(f"[rigid] {smi}: config {config} ({con.name}, {D}D, "
                  f"window {c['window']}) via {route}, B={len(rms)}: "
                  f"launches {n}, {wall:.3f} s, mean rms {rms.mean():.3e}, "
                  f"median |pos - truth| {med:.5f} px, max bond error "
                  f"{bond:.2e} px, converged {conv_frac:.4f}, mean LM iters "
                  f"{float(iters.float().mean()):.2f}", flush=True)
            launches[(config, route)] = _launched(n, route)
            launches["window_gather"] += n["window_gather"]
            check(launches[(config, route)] > 0,
                  f"config {config} did not launch its {route} kernel")
            others = sum(v for k, v in n.items() if k not in (
                "fused_lm_2d" if route == "fused" else route,
                "window_gather"))
            check(others == 0, f"config {config} {route} launched {n}")
            check(D == 2 or n["window_gather"] > 0,
                  f"config {config} did not launch window_gather")
            check(np.isfinite(rms).all(), "non-finite rms")
            check(rms.mean() < 0.1, f"mean rms {rms.mean()}")
            check(med < 0.05, f"median position error {med} px")
        solve, args = entry_rigid(config, device, batch=batch)
        plain, _ = entry_rigid(config, device, batch=batch,
                               lm_backend="torch", gather_backend="torch")
        r = [_rate(plain, args, RIGID_REPS_PLAIN, RIGID_BLOCKS),
             _rate(solve, args, RIGID_REPS_KERNEL, RIGID_BLOCKS),
             _rate(solve, args, RIGID_REPS_KERNEL, RIGID_BLOCKS),
             _rate(plain, args, RIGID_REPS_PLAIN, RIGID_BLOCKS)]
        print(f"[rigid] {smi}: config {config} bucket solver B={len(args[4])}"
              f" clusters/s — kernel route {r[1][0]:.1f} (disp "
              f"{r[1][1]:.3f}), {r[2][0]:.1f} (disp {r[2][1]:.3f}); plain "
              f"route {r[0][0]:.1f} (disp {r[0][1]:.3f}), {r[3][0]:.1f} "
              f"(disp {r[3][1]:.3f})", flush=True)
        wall, dev = _profile(solve, args)
        lm = sum(v for k, v in dev.items() if "lm_2d_kernel" in k
                 or "pixel_lm_kernel" in k)
        gather = sum(v for k, v in dev.items() if "window_gather" in k)
        others = sorted(((v, k) for k, v in dev.items()
                         if "lm_2d_kernel" not in k and "pixel_lm_kernel"
                         not in k and "window_gather" not in k),
                        reverse=True)
        rest = sum(v for v, _ in others)
        idle = 1.0 - (lm + gather + rest) / wall
        print(f"[rigid] {smi}: config {config} kernel route, per solve: wall "
              f"{wall:.3f} ms (unprofiled); device LM kernel {lm:.3f} ms, "
              f"window_gather {gather:.3f} ms, {len(others)} other "
              f"kernels/copies {rest:.3f} ms (top: "
              + "; ".join(f"{k[:40]} {v:.3f}" for v, k in others[:3])
              + f"); device idle share {idle:.3f}", flush=True)
        check(lm > 0, f"the config {config} profile saw no LM kernel")
    return launches


def phase_refine_rigid(batches, device, smi):
    """refine_leastsq(constraints=...) on 64 clusters of each pose kind's
    cell (2D dimer, trimer, fitted-distance dimer; 3D axis dimer,
    rotation-vector tetramer), on CUDA: the rigid kernel route, its
    launches, exact geometry, and agreement with lm_backend='torch'
    within POS_ATOL; then a generic constraint dict, which takes
    lm_solve (tag cuda-torch-penalty)."""
    import torch

    from clustertracking_tpu_torch import diagnostics, refine_leastsq
    from clustertracking_tpu_torch.constraints import dimer_global

    cases = [("3-dimer", None), ("3-trimer", None),
             ("3-dimer", dimer_global(2, mode="cluster")), ("3b", None),
             ("3c", None), ("3-dimer", "generic")]
    total = {}
    for config, con in cases:
        c, _ = _rigid_layout(config)
        con = c["con"] if con is None else con
        D, B = c["ndim"], 64
        frames, fidx, params0, _, _, truth = batches[config]
        small = (frames[:1], fidx[:B], params0[:B])
        f, cols = _scene_frame(small, D)
        sep = 4.5 if config == "3c" else 7.0
        if con == "generic":
            con = {"type": "eq", "cluster_size": 2, "args": (5.0,),
                   "fun": lambda p, d: torch.linalg.norm(p[0] - p[1]) - d}
        kw = dict(diameter=tuple(2 * r for r in c["radius"]), separation=sep,
                  constraints=con, param_val={"size": c["size"]},
                  device=device)
        _reset_counts()
        t0 = time.perf_counter()
        with diagnostics.collect() as stats:
            out_k = refine_leastsq(f, small[0], **kw)
        wall = time.perf_counter() - t0
        n = _counts()
        out_p = refine_leastsq(f, small[0], lm_backend="torch", **kw)
        n_cl = con["cluster_size"] if isinstance(con, dict) \
            else con.cluster_size
        pos = out_k[cols].to_numpy().reshape(B, n_cl, D)
        dpos = float(np.abs(out_k[cols].to_numpy()
                            - out_p[cols].to_numpy()).max())
        err = float(np.median(np.abs(pos - truth[:B]).max(axis=-1)))
        routes = sorted({b.backend for b in stats.batches})
        name = "generic dict" if isinstance(con, dict) else con.name
        if isinstance(con, dict):
            want = ["cuda-torch-penalty"]
            dev = float(np.abs(_edges(pos) - 5.0).max())
            check(dev <= 1e-3, f"penalty bond lengths off by {dev} px")
        else:
            want = ["cuda-" + ("fused" if D == 2 else "gathered") + "-rigid"]
            dev = _bond_check(pos, con, f"refine_leastsq {name} {D}D")
            if con.dist is None:   # the fitted length is the drawn one
                learned = float(np.abs(_edges(pos) - 5.0).max())
                check(learned < 0.05, f"{name}: fitted bond length off by "
                      f"{learned} px")
        print(f"[refine_rigid] {smi}: {name} {D}D ({config} scene, {B} "
              f"clusters): {wall:.2f} s, {routes}, launches {n}, max bond "
              f"deviation {dev:.2e} px, max |dpos| vs lm_backend='torch' "
              f"{dpos:.2e} px, median |pos - truth| {err:.5f} px, accepted "
              f"{np.isfinite(out_k['cost'].to_numpy()).mean():.4f}",
              flush=True)
        check(routes == want, f"{name} took {routes}, not {want}")
        check(np.isfinite(out_k["cost"].to_numpy()).all(),
              f"{name}: rejected fits")
        check(dpos <= POS_ATOL, f"{name}: kernel and torch routes differ "
              f"by {dpos} px")
        check(err < 0.05, f"{name}: median position error {err} px")
        if not isinstance(con, dict):
            check(sum(n.values()) > 0, f"{name}: no kernel launched")
        total = {k: total.get(k, 0) + v for k, v in n.items()}
    return total


_T0 = time.perf_counter()


def _stamp(phase):
    print(f"[time] {phase} done at {time.perf_counter() - _T0:.1f} s",
          flush=True)


def main():
    smi = phase_device()
    _stamp("device")
    import torch

    from clustertracking_tpu_torch.entry import (
        RIGID_CONFIGS, example_batch, example_batch_3d, example_batch_rigid)

    device = "cuda"
    phase_build()
    _stamp("build")
    batch = example_batch(B=B_FULL, frame_size=FRAME, grid_pitch=PITCH,
                          with_truth=True)
    k = phase_kernel(batch, device, smi)
    _stamp("kernel")
    launches = phase_main(batch, device, smi)
    _stamp("main")
    phase_rates(batch, device, smi)
    _stamp("rates")
    phase_refine(batch, device, smi)
    _stamp("refine")
    del batch
    batch3d = example_batch_3d(B=B_3D, with_truth=True)
    k3 = phase_kernel3d(batch3d, device, smi)
    _stamp("kernel3d")
    n3 = phase_main3d(batch3d, device, smi)
    _stamp("main3d")
    _, solve_big, args_big = phase_rates3d(batch3d, device, smi)
    _stamp("rates3d")
    phase_profile3d(solve_big, args_big, smi)
    _stamp("profile3d")
    del solve_big, args_big
    torch.cuda.empty_cache()
    n2 = phase_stream2d(device, smi)
    _stamp("stream2d")
    r3 = phase_refine3d(batch3d, device, smi)
    _stamp("refine3d")
    del batch3d
    kp, np_ = phase_profiles(device, smi)
    _stamp("profiles")
    rigid = {c: example_batch_rigid(c, with_truth=True) for c in RIGID_CONFIGS}
    kr = phase_kernel_rigid(rigid, device, smi)
    _stamp("kernel_rigid")
    nr = phase_rigid(rigid, device, smi)
    _stamp("rigid")
    rr = phase_refine_rigid(rigid, device, smi)
    _stamp("refine_rigid")
    # launches of the gathered route's kernels over the paths that drive it
    n3 = {nm: n3[nm] + n2[nm] + (r3 or {}).get(nm, 0) for nm in n3}
    n3["window_gather"] += nr["window_gather"] + rr["window_gather"]
    for name in ("window_gather", "resident", "streamed"):
        check(n3[name] > 0, f"no path of the 3D slice launched {name}")
    src = "clustertracking_tpu_torch/csrc/"
    lm = "clustertracking_tpu/ops/pallas_lm.py:"
    kernels = [
        dict(name="fused_lm_2d", route="cuda", source=src + "fused_lm_2d.cu",
             replaces=lm + "1213", launches=launches, **k),
        dict(name="window_gather", route="cuda",
             source=src + "window_gather.cu",
             replaces="clustertracking_tpu/ops/pallas_gather.py:144",
             launches=n3["window_gather"], **k3["gather"]),
        dict(name="pixel_lm (resident)", route="cuda",
             source=src + "pixel_lm.cu", replaces=lm + "1143",
             launches=n3["resident"], **k3["resident"]),
        dict(name="pixel_lm (streamed)", route="cuda",
             source=src + "pixel_lm.cu", replaces=lm + "1161",
             launches=n3["streamed"], **k3["streamed"]),
    ]
    # the rigid-pose variants: 2D n-gon (pallas_lm.py:570), 3D dimer axis
    # (:589), 3D rotation vector (:612)
    pose_line = {"3-dimer": "570", "3-trimer": "570", "3b": "589",
                 "3c": "612"}
    for (config, route), entry in kr.items():
        kernel = ("fused_lm_2d" if route == "fused"
                  else f"pixel_lm ({route})")
        kernels.append(dict(
            name=f"{kernel} [rigid, config {config}]", route="cuda",
            source=src + ("fused_lm_2d.cu" if route == "fused"
                          else "pixel_lm.cu"),
            replaces=lm + pose_line[config], launches=nr[(config, route)],
            **entry))
    # the profiles, inside the three kernels' sweeps
    kernel_line = {"fused": "1213", "resident": "1143", "streamed": "1161"}
    for (name, route), entry in kp.items():
        kernel = ("fused_lm_2d" if route == "fused"
                  else f"pixel_lm ({route})")
        kernels.append(dict(
            name=f"{kernel} [{name}]", route="cuda",
            source=src + ("fused_lm_2d.cu" if route == "fused"
                          else "pixel_lm.cu"),
            replaces=lm + kernel_line[route], launches=np_[(name, route)],
            **entry))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def _ptxas_registers(report):
    """(kernel, registers) of each entry in nvcc's -Xptxas -v report."""
    out, entry = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry is not None:
            out.append((entry, int(line.split("Used")[1].split()[0])))
            entry = None
    return out


def gauss_kernels(root):
    """The unconstrained gauss kernels of the port found under ``root``
    (this checkout, or another one such as the parent commit's), timed on
    one card: fused_lm_2d at config 1's first-round inputs (B=16,384) and
    pixel_lm resident and streamed at config 4's (B=2,048), each against
    its plain version, with the kernels' registers and pixel_lm's
    occupancy.  One line; run two checkouts in turns to compare them."""
    sys.path.insert(0, root)
    import torch

    from clustertracking_tpu_torch.entry import example_batch, example_batch_3d
    from clustertracking_tpu_torch.entry import WINDOW_3D
    from clustertracking_tpu_torch.ops import _build
    from clustertracking_tpu_torch.ops.fused_lm import (
        fused_lm_2d, fused_lm_2d_reference)
    from clustertracking_tpu_torch.ops.pixel_lm import (
        occupancy, pixel_lm, pixel_lm_reference)

    check(torch.cuda.is_available(), "no CUDA device")
    device = "cuda"
    _build.build_kernels(("fused_lm_2d", "pixel_lm"))
    # the gauss, unconstrained instantiations (template arguments after
    # D and the mode all 0, or none), by kernel name
    regs = {}
    for n in ("fused_lm_2d", "pixel_lm"):
        for entry, r in _ptxas_registers(_build.build_log(n)[1]):
            args = entry.split("_kernel", 1)[1].split("EEEv")[0]
            if args.startswith("ENS") or args.endswith(("ELi0ELi0", "Lb0",
                                                         "Lb1", "ILi0ELi0")):
                regs[f"{n}{args[:12]}"] = r
    batch = example_batch(B=B_FULL, frame_size=FRAME, grid_pitch=PITCH)
    args, kw, layout = _first_round_inputs(batch, device)
    pos_slots = sorted({int(s) for p in layout.pos_param_idx
                        for s in layout.slot_idx[:, p]})
    a2 = _agreement(fused_lm_2d(*args, **kw),
                    fused_lm_2d_reference(*args, **kw), pos_slots)
    ms2 = _cuda_ms(lambda: fused_lm_2d(*args, **kw), 20)
    st, args3, kw3, layout3 = _first_round_inputs_3d(
        example_batch_3d(B=B_3D), device)
    pos3 = sorted({int(s) for p in layout3.pos_param_idx
                   for s in layout3.slot_idx[:, p]})
    res_p = pixel_lm_reference(*args3, **kw3)
    ms3, a3 = {}, {}
    for mode in ("resident", "streamed"):
        def call():
            return pixel_lm(*args3, **kw3, streaming=mode == "streamed")
        a3[mode] = _agreement(call(), res_p, pos3)
        ms3[mode] = _cuda_ms(call, 20)
    print(f"[gauss_kernels] {root}: fused_lm_2d config 1 B={B_FULL} "
          f"{ms2:.4f} ms (max |dpos| {a2['pos']:.3e}, cost rel "
          f"{a2['cost_rel']:.3e}, converged equal {a2['conv']:.5f}); "
          f"pixel_lm config 4 B={B_3D} resident {ms3['resident']:.4f} ms, "
          f"streamed {ms3['streamed']:.4f} ms (max |dpos| "
          f"{max(a['pos'] for a in a3.values()):.3e}, cost rel above floor "
          f"{max(a['cost_rel_above_floor'] for a in a3.values()):.3e}); "
          f"occupancy {occupancy(WINDOW_3D)} warps/SM; registers {regs}",
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gauss-kernels"]:
        gauss_kernels(sys.argv[2] if len(sys.argv) > 2 else ".")
    else:
        main()
