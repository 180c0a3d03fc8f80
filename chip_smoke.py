#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --gauss-kernels DIR [--save FILE]
    python3 chip_smoke.py --gather-kernels DIR
    python3 chip_smoke.py --compare-saved FILE_A FILE_B

``--gauss-kernels`` times the gauss LM kernels of the port found under DIR
(this checkout or another commit's) at configs 1, 4, 3 (dimers) and 3c;
``--save`` keeps their per-lane results, and ``--compare-saved`` gives the
share of lanes on which two such files agree bit for bit.
``--gather-kernels`` times the window gather found under DIR at config 4,
B=2,048 and 16,384 (kernel alone with L2 flushed, per call, host time per
call).

Drives the port (``clustertracking_tpu_torch``; no JAX) through its main
paths, the bucketed cluster fit and the pipelines around it, at the
reference's own sizes: 16,384 two-Gaussian dimers on 64 frames of
256×256 in 13×13 windows (bench.py's configuration), config 4 of
benchmarks/suite.py, 2,048 anisotropic 3D dimers in 8 z-stacks of
64×192×192 in 9×13×13 windows, the rigid cells, configs 3 (4,096
dimers, 4,096 trimers), 3b and 3c (2,048 3D dimers, 2,048 tetramers),
and the tracking videos of configs 2 and 5.  Phases, one line or more
each:

1. device   — fail unless CUDA is available; the card's name and power
              limit as nvidia-smi reports them;
2. build    — build csrc/fused_lm_2d.cu, window_gather.cu and pixel_lm.cu
              (one nvcc each, sm_90a, started together) and time them;
              each instantiation's registers, the warps per SM they allow,
              and any spill;
3. kernel   — one fused_lm_2d launch against fused_lm_2d_reference on the
              same CUDA tensors, held to the stated tolerances, and timed
              beside its bound;
4. main     — the entry() bucket solver through the full refit-on-shift
              loop; the kernel's launch count, rms and position accuracy;
5. rates    — bucket-solver clusters/s with the kernel and with the plain
              version (bench.py's method; the plain one over PLAIN_BLOCKS
              blocks), and the serial scipy rate; then
              (profile) torch.profiler over the same solver: the kernel
              against the rest of a solve, and the device's idle share;
6. refine   — refine_leastsq on the same scene as a 32,768-row DataFrame
              (only where pandas imports);
7. kernel3d — config 4's first-round inputs at B=2,048 and 16,384:
              window_gather against gather_stack (bit-equal), timed kernel
              alone with L2 flushed, per call and host µs per call, beside
              the bytes bound; the wrapper's host work against its bare
              launch; pixel_lm resident and forced
              streamed against pixel_lm_reference and each other, timed;
              then both modes against the plain version on the same scene
              with noise, where cost is compared on every lane;
8. main3d   — the entry_3d() bucket solver (the gathered route), with
              pixel_lm's mode picked by occupancy and with each mode
              forced; per-mode launch counts, rms and position accuracy;
9. rates3d  — config 4 clusters/s, gathered route and plain route at
              B=2,048 (the plain route over PLAIN_BLOCKS blocks, as in
              rates), gathered route at B=16,384 with the kernels'
              occupancy;
10. profile3d — torch.profiler at B=16,384: gather vs solve vs the rest,
              and the device's idle share;
11. stream2d — the entry scene with 161×161 windows, which only the
              streamed gathered route takes, against the plain route,
              with window_gather held bit-equal to gather_stack;
12. refine3d — refine_leastsq on config 4's scene as a DataFrame;
13. profiles — ring, hat, disc, inv_series_2: fused_lm_2d and pixel_lm
              (both modes) against their plain versions, timed beside
              gauss on the same scenes; then refine_leastsq in 2D and 3D
              and the 3D bucket solver per mode, with launch counts;
14. kernel_rigid — each rigid instantiation (2D n-gon; 3D axis and
              rotation vector, both modes) against its plain version on
              its cell's first round, noise-free and with noise σ=1;
15. rigid   — configs 3, 3b, 3c through entry_rigid: launch counts
              (3b, 3c: window_gather bit-equal to gather_stack), accuracy,
              bond lengths, kernel and plain route clusters/s,
              and a torch.profiler breakdown;
16. refine_rigid — refine_leastsq(constraints=...) per pose kind against
              lm_backend='torch', and a generic constraint dict;
17. locate  — config 2's video (100 frames of 512×512, 50 Brownian dimers
              each, benchmarks/suite.py::_video): _locate_frames raw,
              bandpassed and bandpassed with a 64-px tile threshold, on
              the card (all 100 frames) and on the host (the first 64, one
              stack chunk: every code path), candidates identical on the
              raw path, at least 99.9% on the filtered ones; ms per frame,
              recall against the truth, local_maxima_topk per frame;
18. train   — train_leastsq on 8 frames of 512×512 drawn with
              tests/test_train.py's inverse-series PSF (289 clusters a
              frame, singles and dimers): the learned coefficients within
              0.05 of the truth, seconds per round, lm_solve_global per
              call, the device's idle share, window_gather bit-equal to
              gather_stack on the first global bucket's windows and
              timed; then refine_leastsq with the
              learned coefficients on every feature, through fused_lm_2d's
              inv_series_2 profile, held to lm_backend='torch' and to the
              truth, and fused_lm_2d vs plain on that refit's first launch;
19. global  — locate's raw candidates → find_clusters → refine_leastsq
              (constraints=dimer_global(ndim=2)): one bond length for the
              whole video, within 0.02 px of the drawn 5 px, rigid to 1e-3
              px on every accepted dimer, window_gather bit-equal to
              gather_stack on the first global bucket's windows and timed,
              and the n-gon fused_lm_2d vs plain on the fixed-distance
              refit's first launch;
20. find    — the device label propagation (float64) at separation 6 on
              config 5's first frame of locate candidates (4 frames of
              1024×1024, 5,000 dimers, seed 5: benchmarks/suite.py's
              config 5), uniform points at its density (N = 8,192 to
              65,536) and a 1,000-point chain: labels equal to the exact
              partition's, to the CPU propagation's up to N = 10,000, and
              to the host's wherever its float test decides every pair
              exactly; ms against the host, propagation rounds;
21. link    — the host Linker, the dense and the binned auction on the
              truth rows of configs 2 and 5: the card's auction equal to
              the CPU's particle for particle, 'auto' resolving to each,
              trajectories equal to the host's (config 2) or on 99.9% of
              rows (config 5); ms per frame, rounds and host syncs;
22. track   — config 2's video through track (suite.py's kwargs): frames/s,
              the loss ledger, accuracy and recall against the truth,
              diffusion constants beside the scene's; the first 8 frames
              on the card against the CPU; checkpointed and resumed
              against the single-shot host-linked run; fused_lm_2d vs
              plain on its first launch;
23. track5  — config 5 through track: the binned auction, fused_lm_2d and
              window_gather launches, dispatches by tag, accuracy, the
              device's idle share; both kernels vs plain on their first
              launches;
24. synth   — ops/synth.frames_from_df at config 5's size (4 frames of
              1024×1024, 10,000 features each) on the card: against the
              CPU's render and artificial.CoordinateReader, two renders
              bit-equal, ms per frame, the noise's statistics;
25. track_r — config 2 with recover_passes=1 and with
              transfer_dtype='float16' (suite.py::config2's variants):
              frames/s, ledger, accuracy; 8 frames with the recovery pass
              on the card against the CPU; checkpointed recovery runs
              against the single-shot host-linked one and resumed against
              uninterrupted; fused_lm_2d vs plain on the recovery refit's
              first launch;
26. track5r — config 5 with recover_passes=1, scored as
              benchmarks/recovery_exp.py scores it and gated by the
              reference's own one-pass accuracy (coverage ≥ 93.6%, ghosts
              ≤ 1.3% of the outputs, median error ≤ 0.095 px): stage
              walls, summary_by_backend, launches, idle share;
              fused_lm_2d and window_gather vs plain on the recovery
              refit's first launches;
27. trace   — diagnostics.trace_to around one config 2 track call: one
              trace file holding the stage ranges and the card's kernels;
28. mesh    — the multi-device path over a 4-shard mesh on the visible
              cards in turn (["cuda:0"] * 4 on a one-card host; the line
              names the distinct cards): (a) config 1 through
              refine_leastsq(mesh=), every lane bit-equal to [refine] and
              fused_lm_2d launched on every shard; (b) config 4 the same
              against [refine3d] (pixel_lm streamed), and entry_3d's
              bucket through sharded_fit (resident) against its
              one-device solver; (c) a tie across the shards, config 2's
              video in one dispatch with the size 'global' and
              dimer_global(): the tied values identical on every lane,
              within 1e-4 of one device, two runs bit-equal; (d)
              link(mesh=) on configs 2 and 5's truth rows (config 5 in
              one-frame shards): card = CPU particle for particle,
              trajectories the single scan's (config 2) or on 99.9% of the
              rows (config 5), the stitch's wall; (e) track(mesh=) on
              config 2 against one device, both timed in this call, with
              [track]'s gates; then each kernel of the sharded path
              against its plain version on its first shard launch.

A [time] line follows each phase (17-28 also print their own seconds).
Then one JSON line describing each
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
PLAIN_BLOCKS = 3      # the same, for the plain routes' rates
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
FLUSH_BYTES = 128 << 20   # read between timed gathers: over the 50 MB L2
GATHER_REPS = 20
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
# [locate] and [global]: config 2's video (benchmarks/suite.py::_video)
LOC_FRAMES = 100
LOC_SHAPE = (512, 512)
LOC_DIMERS = 50
LOC_BOND = 5.0
LOC_SIZE = 1.6
LOC_NOISE = 2.0
LOC_DIAMETER = 9
LOC_SEPARATION = 6
LOC_AGREE = 0.999     # share of filtered-path candidates identical
LOC_HOST_FRAMES = 64  # frames located on the host too: one stack chunk
SIZE_RTOL = 1e-4      # locate sizes, card vs host
# [train]: tests/test_train.py's inverse-series PSF at full frame size
TRAIN_FRAMES = 8
TRAIN_COEFFS = (0.8, 0.25)
TRAIN_TOL = 0.05      # |learned - truth|, test_train.py's tolerance
TRAIN_POS_TOL = 0.03  # px, test_train_feeds_back_into_refine's
GLOBAL_DIST_TOL = 0.02
GLOBAL_PTP_TOL = 1e-3
# the tracking pipeline: config 2 is _video()'s scene (LOC_*), config 5
# benchmarks/suite.py::config5's: 4 frames of 1024², 5,000 dimers, seed 5
C5_FRAMES = 4
C5_SHAPE = (1024, 1024)
C5_DIMERS = 5000
C5_SEED = 5
FIND_SEP = 6.0
FIND_DENSITY = 0.0095  # config 5's features per px²
FIND_NS = (8192, 16384, 32768, 65536)
FIND_CPU_MAX = 10000   # sets up to this size also propagate on the host
FIND_REPS = 5          # timed calls per set, median reported
LINK_AGREE = 0.999     # config 5: share of rows in identical trajectories
TRACK_KW = dict(diameter=LOC_DIAMETER, separation=LOC_SEPARATION,
                search_range=3.0, memory=6, link_backend="device")
TRACK5_KW = dict(diameter=LOC_DIAMETER, separation=LOC_SEPARATION,
                 search_range=3.0, memory=2, link_backend="auto",
                 max_features=16384, max_cluster_size=40)
TRACK_ERR = 0.05       # px, median position error of tracked rows
# config 5 packs 10,000 features a frame: blended pairs and chains put the
# median at 0.075 px in the reference without recovery passes
# (benchmarks/RESULTS.md:96), and the port's plain route matches it
TRACK5_ERR = 0.08
TRACK_RECALL = 0.9     # share of truth feature-frames tracked within 1 px
TRACK_CPU_FRAMES = 8   # frames of config 2 tracked on the card and the CPU
TRACK_POS_ATOL = 1e-3  # px, kernel route against the plain one
CKPT_POS_ATOL = 1e-5   # px, checkpointed against single-shot
D_TRUTH = (0.125, 0.005)  # _video(): step σ 0.5 px per axis, 0.1 rad
# the recovery slice: the render at config 5's size, and config 5 with one
# recovery pass held to the reference's own recorded one-pass accuracy
# (benchmarks/RESULTS.md:97: 94.6% coverage, ghosts 1.0% of the outputs,
# median error 0.088 px)
SYNTH_REPS = 5
SYNTH_ATOL = 1e-4      # × the largest signal: the card's render vs the CPU's
SYNTH_TAIL = 1e-3      # vs CoordinateReader: one feature's truncated tail
SYNTH_REACH = (5 * LOC_SIZE + 1) * 2 ** 0.5  # px: a window's corner
CKPT_FRAMES = 32       # config 2 frames of the checkpointed recovery runs
# the recovery ledger's accept-stage counts (the rest come before it)
ACCEPT_KEYS = ("refit_failures_restored", "ghosts_pruned",
               "recovery_rejected_likelihood", "recovery_pruned_zero_signal",
               "recovery_pruned_low_signal", "recovery_pruned_displacement",
               "recovery_pruned_duplicate")
TRACK5R_COVERAGE = 0.936
TRACK5R_GHOSTS = 0.013    # share of the outputs
TRACK5R_ERR = 0.095
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
        # (D, streamed, profile, pose, slot ceiling; fused_lm_2d: profile,
        # pose, slot ceiling) = registers/warps per SM that they allow
        # window_gather: 256 threads per block (kThreads in the .cu)
        entries = _ptxas_entries(report)
        wpb = 8 if name == "window_gather" else 1   # warps per block
        regs = " ".join(
            ",".join(_template_args(e))
            + f"={r}/{_warps_by_registers(r, wpb)}" for e, r, _ in entries)
        spills = [f"{','.join(_template_args(e))}: {b} bytes"
                  for e, _, b in entries if b]
        print(f"[build] {name}: nvcc {nvcc_s:.1f} s, load {wall:.1f} s; "
              f"registers/warps per SM {regs or 'cached build'}; spilling: "
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
    print(f"[kernel] {smi}: fused_lm_2d bound {bound['bound_ms']:.4f} ms, "
          f"time over bound {ms / bound['bound_ms']:.1f}x "
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
    rate_p1, disp_p1 = _rate(plain, args, REPS_PLAIN, PLAIN_BLOCKS)
    rate_k1, disp_k1 = _rate(solve, args, REPS_KERNEL)
    rate_k2, disp_k2 = _rate(solve, args, REPS_KERNEL)
    rate_p2, disp_p2 = _rate(plain, args, REPS_PLAIN, PLAIN_BLOCKS)
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
    return f, frames, out


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


def _flush_l2():
    """Read FLUSH_BYTES on the card (one reduction), so that the next
    kernel finds none of its data in the 50 MB L2 (and only clean lines:
    nothing to write back)."""
    import torch

    buf = getattr(_flush_l2, "buf", None)
    if buf is None:
        buf = _flush_l2.buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    buf.sum()


def _kernel_alone_ms(fn, reps, cold=True):
    """``fn``'s own device time per call by torch.profiler (every kernel
    and copy it runs but the flush's reduction and memset), with L2
    flushed before each call when ``cold``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _flush_l2()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a profile now and then records no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    _flush_l2()
                fn()
            torch.cuda.synchronize()
        ms = sum(v for k, v in _device_ms(prof).items()
                 if "reduce_kernel" not in k and "Memset" not in k) / reps
        if ms > 0:
            return ms
    check(False, "three profiles recorded no device time")


def _host_us(fn, n=200):
    """Host time per call in µs: ``n`` calls enqueued with no sync between
    them, so nothing waits for the device."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / n * 1e6


def _gather_cell(frames, fidx, origin, window, reps):
    """One gather shape: window_gather held bit-equal to gather_stack, and
    both timed — kernel alone with L2 flushed before each call, per call
    (CUDA events over back-to-back calls, L2 warm) and host µs per call —
    beside the bytes bound."""
    import torch

    from clustertracking_tpu_torch.ops.gather import gather_stack
    from clustertracking_tpu_torch.ops.window_gather import window_gather

    want = gather_stack(frames, fidx, origin, window)
    out = dict(bytes=2 * want.nbytes + origin.nbytes + fidx.nbytes)

    def call():
        return window_gather(frames, fidx, origin, window)

    got = call()
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"window_gather differs from gather_stack at B={len(fidx)}")
    out["kernel"] = dict(kernel=_kernel_alone_ms(call, reps),
                         call=_cuda_ms(call, 20), host=_host_us(call),
                         err=float((got - want).abs().max()))
    del got

    def plain():
        return gather_stack(frames, fidx, origin, window)

    out["plain"] = dict(kernel=_kernel_alone_ms(plain, max(reps // 4, 2)),
                        call=_cuda_ms(plain, 5), host=_host_us(plain, 20))
    return out


def _fmt_gather(name, t, bound_ms):
    return (f"{name} kernel alone {t['kernel']:.4f} ms "
            f"({bound_ms / t['kernel']:.3f} of the bound), per call "
            f"{t['call']:.4f} ms, host {t['host']:.1f} µs per call")


def phase_kernel3d(batch, big, device, smi):
    import torch

    from clustertracking_tpu_torch.entry import WINDOW_3D
    from clustertracking_tpu_torch.ops.pixel_lm import (
        pixel_lm, pixel_lm_reference)
    from clustertracking_tpu_torch.ops.window_gather import _launch

    gather = {}
    for B, b in ((B_3D, batch), (B_3D_BIG, big)):
        st, args, kw, layout = _first_round_inputs_3d(b, device)
        g = _gather_cell(st.frames, st.frame_idx, args[4], WINDOW_3D,
                         GATHER_REPS)
        g["bound"] = _bound(g["bytes"], 0)
        gather[B] = g
        bound_ms = g["bound"]["bound_ms"]
        print(f"[kernel3d] {smi}: window_gather at B={B}, {WINDOW_3D}, "
              f"bit-equal to gather_stack; L2 flushed (a "
              f"{FLUSH_BYTES >> 20} MB read) before each kernel-alone "
              f"call: " + "; ".join(_fmt_gather(v, g[v], bound_ms)
                                   for v in ("kernel", "plain"))
              + f"; bound {bound_ms:.4f} ms (bytes)", flush=True)
        del st
    # the wrapper's host work at B=2,048 against its bare launch
    st, args, kw, layout = _first_round_inputs_3d(batch, device)
    out = torch.empty((B_3D, int(np.prod(WINDOW_3D))), device=device)
    bare_us = _host_us(lambda: _launch(st.frames, st.frame_idx, args[4],
                                       WINDOW_3D, out))
    print(f"[kernel3d] {smi}: window_gather host work at B={B_3D}: "
          f"{gather[B_3D]['kernel']['host']:.1f} µs per wrapper call, of "
          f"which the bare launch (ctypes call and kernel launch) "
          f"{bare_us:.1f} µs", flush=True)

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
    bounds = {m: _lm_bound(out[m]["res"], args, kw) for m in out}
    print(f"[kernel3d] {smi}: bounds — pixel_lm "
          + ", ".join(f"{m} {b['bound_ms']:.4f} ms ({b['bound_by']}; time "
                      f"over bound {out[m]['ms'] / b['bound_ms']:.1f}x)"
                      for m, b in bounds.items()), flush=True)
    # the gather: per call at config 4 and the kernel alone at both sizes;
    # gather_stack, one advanced-index read, is the PyTorch call that
    # computes the same
    g = gather[B_3D]
    return dict(
        gather=dict(
            max_abs_err=max(gather[b]["kernel"]["err"] for b in gather),
            ms=g["kernel"]["call"], plain_ms=g["plain"]["call"],
            **g["bound"], library_ms=g["plain"]["call"],
            kernel_ms={v: {b: gather[b][v]["kernel"] for b in gather}
                       for v in ("kernel", "plain")},
            bound_ms_by_batch={b: gather[b]["bound"]["bound_ms"]
                               for b in gather}),
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
    """Config 4 through the bucket solver three times: pixel_lm's mode as
    streaming=None picks it (by occupancy), then each mode forced
    (streaming=True and False, the reference's make_pallas_lm option).
    Returns the launch counts of the three runs, summed: the forced runs
    give each mode's own count at config 4's shape."""
    import torch

    from clustertracking_tpu_torch.entry import entry_3d

    total, outs = {}, {}
    for streaming in (None, True, False):
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
        if streaming is not None:
            forced, other = (("streamed", "resident") if streaming
                             else ("resident", "streamed"))
            check(n[forced] > 0 and n[other] == 0,
                  f"streaming={streaming} launched {n}")
        check(n["fused_lm_2d"] == 0, "the 3D path launched fused_lm_2d")
        check(np.isfinite(rms).all(), "non-finite rms")
        check(rms.mean() < 0.2, f"mean rms {rms.mean()}")
        check(med < 0.05, f"median position error {med} px")
        total = {k: total.get(k, 0) + v for k, v in n.items()}
        outs[streaming] = pos
    for a, b in ((True, False), (None, True)):
        dpos = float(np.abs(outs[a] - outs[b]).max())
        check(dpos <= POS_ATOL, f"the fits of streaming={a} and "
              f"streaming={b} differ by {dpos} px")
    return total


def phase_rates3d(batch, big, device, smi):
    import torch

    from clustertracking_tpu_torch.entry import (
        WINDOW_3D, entry_3d)
    from clustertracking_tpu_torch.ops.pixel_lm import (
        occupancy, pick_streaming)

    solve, args = entry_3d(device, batch=batch)
    plain, _ = entry_3d(device, batch=batch, lm_backend="torch",
                        gather_backend="torch")
    rate_p1, disp_p1 = _rate(plain, args, REPS_PLAIN, PLAIN_BLOCKS)
    rate_k1, disp_k1 = _rate(solve, args, REPS_KERNEL)
    rate_k2, disp_k2 = _rate(solve, args, REPS_KERNEL)
    rate_p2, disp_p2 = _rate(plain, args, REPS_PLAIN, PLAIN_BLOCKS)
    solve_big, args_big = entry_3d(device, batch=big)
    rate_big, disp_big = _rate(solve_big, args_big, REPS_KERNEL // 4)
    occ = occupancy(WINDOW_3D, n_slots=14)   # config 4: V = 14
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
    return solve_big, args_big


def _device_ms(prof):
    """Device time by kernel (and copy) name in a torch.profiler run, in
    ms.  Only the device's own events count: a CPU op such as aten::sum
    reports its kernels' time as its own too, the record_function ranges
    are device spans that hold kernels, and the profiler's own buffer
    requests are not the program's work.  It reads the profiler's raw
    events: key_averages() takes ~80 µs an event, minutes for a pipeline
    of 1e5 small kernels."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                and name != "Activity Buffer Request"
                and not name.startswith(("refit_round", "fit_bucket"))):
            out[name] = out.get(name, 0.0) + e.duration_ns() / 1e6
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


def phase_profile(batch, device, smi):
    """torch.profiler over config 1's bucket solver: the LM kernel against
    the rest of a solve, and the device's idle share."""
    from clustertracking_tpu_torch import entry

    solve, args = entry(device, batch=batch)
    wall, dev = _profile(solve, args)
    lm = sum(v for k, v in dev.items() if "lm_2d_kernel" in k)
    others = sorted(((v, k) for k, v in dev.items()
                     if "lm_2d_kernel" not in k), reverse=True)
    rest = sum(v for v, _ in others)
    print(f"[profile] {smi}: config 1 at B={len(args[4])}, per solve: wall "
          f"{wall:.3f} ms (unprofiled); device fused_lm_2d {lm:.3f} ms, "
          f"{len(others)} other kernels/copies {rest:.3f} ms (top: "
          + "; ".join(f"{k[:40]} {v:.3f}" for v, k in others[:3])
          + f"); device idle share {1.0 - (lm + rest) / wall:.3f}",
          flush=True)
    check(lm > 0, "the profile saw no fused_lm_2d kernel")


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


def _gather_equal(st, window, positions):
    """window_gather bit-equal to gather_stack on every lane of a scene's
    first-round windows (origins around ``positions``, a [B, n, D]
    tensor); raises if not."""
    import torch

    from clustertracking_tpu_torch.ops.gather import gather_stack, origins_for
    from clustertracking_tpu_torch.ops.window_gather import window_gather

    origin = origins_for(positions.contiguous(), window,
                         tuple(st.frames.shape[1:]))
    want = gather_stack(st.frames, st.frame_idx, origin, window)
    got = window_gather(st.frames, st.frame_idx, origin, window)
    check(torch.equal(got, want),
          f"window_gather differs from gather_stack in a {window} window")
    return "bit-equal to gather_stack"


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
    gathered = _gather_equal(st, STREAM_WINDOW, st.params0[..., 2:4])
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
          f" radius {STREAM_RADIUS}: route {route!r}, launches {n} "
          f"(window_gather {gathered}); "
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
    return batch[:5], f, out


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
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
                  f"time over bound {ms / bound['bound_ms']:.1f}x); "
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

    from clustertracking_tpu_torch.constraints import pose_to_positions
    from clustertracking_tpu_torch.interop import from_reference

    launches = {}
    for config, routes in RIGID_ROUTES.items():
        c, _ = _rigid_layout(config)
        con, batch, D = c["con"], batches[config], c["ndim"]
        if D == 3:
            st = from_reference(*batch[:5], device=device)
            print(f"[rigid] {smi}: config {config} window_gather at "
                  f"{c['window']}: " + _gather_equal(
                      st, c["window"], pose_to_positions(st.pose0, con)),
                  flush=True)
            del st
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


def _video(n_frames=LOC_FRAMES, shape=LOC_SHAPE, n_dimers=LOC_DIMERS,
           bond=LOC_BOND, seed=0):
    """A numpy copy of benchmarks/suite.py::_video (config 2's scene):
    Brownian dimers (bond ``bond`` px) drawn by the port's
    CoordinateReader at size 1.6 with noise σ=2.  Returns (frames
    [T, *shape] f32, truth DataFrame)."""
    import pandas as pd

    from clustertracking_tpu_torch.artificial import (
        CoordinateReader, gen_random_locations)

    rng = np.random.default_rng(seed)
    centers = gen_random_locations(tuple(s - 24 for s in shape), n_dimers,
                                   margin=0, rng=rng) + 12.0
    angles = rng.uniform(0, np.pi, n_dimers)
    rows = []
    for t in range(n_frames):
        centers = centers + rng.normal(0, 0.5, centers.shape)
        centers = np.clip(centers, 10, np.asarray(shape) - 10.0)
        angles = angles + rng.normal(0, 0.1, n_dimers)
        offs = (bond / 2.0) * np.stack([np.sin(angles), np.cos(angles)],
                                       axis=-1)
        for k in range(n_dimers):
            for sgn in (+1, -1):
                p = centers[k] + sgn * offs[k]
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 150.0})
    f = pd.DataFrame(rows)
    reader = CoordinateReader(f, shape, size=LOC_SIZE,
                              noise_level=LOC_NOISE)
    frames = np.stack([reader[t] for t in range(n_frames)])
    return frames.astype(np.float32), f


class _Stack:
    """A frame stack as a reader."""

    def __init__(self, frames):
        self.frames = frames

    def __getitem__(self, t):
        return self.frames[t]

    def __len__(self):
        return len(self.frames)


def _recall(cands, truth, r=1.0):
    """Share of true features with a candidate within ``r`` px."""
    from scipy.spatial import cKDTree

    hit = 0
    for t, tr in truth.groupby("frame"):
        c = cands[cands["frame"] == t][["y", "x"]].to_numpy()
        if len(c):
            d, _ = cKDTree(c).query(tr[["y", "x"]].to_numpy(), k=1)
            hit += int((d <= r).sum())
    return hit / len(truth)


def phase_locate(device, smi):
    """_locate_frames over config 2's video on the card, and over its first
    LOC_HOST_FRAMES frames on the host: the raw path candidate for
    candidate, the filtered paths on at least LOC_AGREE of their
    candidates; ms per frame and recall.  Returns (frames, truth, the
    card's raw candidates)."""
    import torch

    from clustertracking_tpu_torch.ops.locate import (
        _candidate_mask, local_maxima_topk)
    from clustertracking_tpu_torch.pipeline import _locate_frames

    t_phase = time.perf_counter()
    frames, truth = _video()
    reader = _Stack(frames)
    args = (reader, range(LOC_FRAMES), (LOC_DIAMETER,) * 2,
            (LOC_SEPARATION,) * 2, None, 64.0, 4096, "frame")
    modes = {"raw": {}, "bandpass": {"preprocess": "bandpass"},
             "tiled": {"preprocess": "bandpass", "threshold_tile": 64}}
    _locate_frames(_Stack(frames[:2]), range(2), *args[2:], device=device)
    raw = None
    for name, kw in modes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = _locate_frames(*args, device=device, **kw)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3 / LOC_FRAMES
        if name == "raw":
            raw = on_card
        t0 = time.perf_counter()
        on_host = _locate_frames(_Stack(frames[:LOC_HOST_FRAMES]),
                                 range(LOC_HOST_FRAMES), *args[2:],
                                 device="cpu", **kw)
        host_ms = (time.perf_counter() - t0) * 1e3 / LOC_HOST_FRAMES
        rec = _recall(on_card, truth)
        on_card = on_card[on_card["frame"] < LOC_HOST_FRAMES]
        key = ["frame", "y", "x"]
        a = {tuple(r) for r in on_card[key].to_numpy()}
        b = {tuple(r) for r in on_host[key].to_numpy()}
        differ = len(a ^ b)
        same_order = (len(on_card) == len(on_host) and np.array_equal(
            on_card[key].to_numpy(), on_host[key].to_numpy()))
        size_rel = (float(np.max(np.abs(on_card["size"].to_numpy()
                                        - on_host["size"].to_numpy())
                                 / on_host["size"].to_numpy()))
                    if same_order and len(on_host) else float("nan"))
        print(f"[locate] {smi}: {name}, {LOC_FRAMES} frames of "
              f"{LOC_SHAPE[0]}x{LOC_SHAPE[1]}: card {card_ms:.3f} ms per "
              f"frame, host {host_ms:.3f} ms per frame (first "
              f"{LOC_HOST_FRAMES} frames); on those, {len(on_card)} "
              f"candidates on the card, {len(on_host)} on the host, "
              f"{differ} differ, same order {same_order}, max size rel "
              f"{size_rel:.2e}; recall within 1 px {rec:.4f} of "
              f"{len(truth)}", flush=True)
        if name == "raw":
            raw_ms = card_ms
            check(same_order, "raw locate: card and host candidates differ")
            check(size_rel <= SIZE_RTOL, f"raw locate sizes differ by "
                  f"{size_rel}")
        else:
            check(differ <= (1.0 - LOC_AGREE) * len(on_host),
                  f"{name} locate: {differ} of {len(on_host)} candidates "
                  "differ between card and host")
        check(rec > 0.5, f"{name} locate recall {rec}")
    # where the card's raw locate spends its time: the device's share
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _locate_frames(*args, device=device)
        torch.cuda.synchronize()
    dev = sum(_device_ms(prof).values())
    print(f"[locate] {smi}: raw, device busy {dev / LOC_FRAMES:.3f} ms per "
          f"frame: idle share {1.0 - dev / (raw_ms * LOC_FRAMES):.3f} of the "
          f"unprofiled {raw_ms:.3f} ms per frame", flush=True)
    # the exact brightest-first path, per frame, on the raw video
    st = torch.as_tensor(frames[:64], device=device)
    T = len(st)
    thr = torch.full((T,), 40.0, device=device)
    sep = (LOC_SEPARATION,) * 2
    ms = _cuda_ms(lambda: local_maxima_topk(st, sep, 4096, thr), 3) / T
    mask_ms = _cuda_ms(lambda: _candidate_mask(st, sep, thr), 3) / T
    print(f"[locate] {smi}: local_maxima_topk {ms:.4f} ms per 512x512 "
          f"frame (of which the candidate mask {mask_ms:.4f} ms), {T} frames "
          f"a call; TF32 flags: matmul {torch.backends.cuda.matmul.allow_tf32}"
          f", cudnn {torch.backends.cudnn.allow_tf32} (the filters are "
          "shifted sums, no cuDNN)", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    print(f"[locate] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return frames, truth, raw


def _train_scene(n_frames=TRAIN_FRAMES, shape=(512, 512), noise=0.0,
                 seed=3):
    """tests/test_train.py's _scene(mixed=True) at full frame size: on a
    grid of pitch 28 (range(25, 490, 28) per axis) jittered by ±3 px, a
    dimer (separation 5) wherever the feature count is a multiple of 3,
    else a single, drawn with the PSF 1/(1 + a1 r² + a2 r⁴), size 2.0,
    signal 180.  Returns (frames [T, *shape] f32, truth DataFrame)."""
    import pandas as pd

    from clustertracking_tpu_torch import artificial

    a1, a2 = TRAIN_COEFFS

    def psf(r2):
        return 1.0 / (1.0 + a1 * r2 + a2 * r2 * r2)

    frames = np.zeros((n_frames,) + shape, np.float32)
    rows = []
    for t in range(n_frames):
        rng = np.random.default_rng(seed + t)
        img = np.zeros(shape)
        grid = [(y, x) for y in range(25, 490, 28)
                for x in range(25, 490, 28)]
        rng.shuffle(grid)
        k = 0
        for c in grid:
            center = np.asarray(c, float) + rng.uniform(-3, 3, 2)
            if k % 3 == 0:
                pos = artificial.draw_cluster(
                    img, center, size=2.0, separation=5.0, n=2,
                    signal=180.0, angle=rng.uniform(0, np.pi),
                    feat_func=psf, cutoff_sigmas=8.0)
            else:
                pos = np.atleast_2d(center + 0.0)
                artificial.draw_feature(img, pos[0], 2.0, 180.0, psf,
                                        cutoff_sigmas=8.0)
            for p in pos:
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 180.0, "size": 2.0})
                k += 1
        if noise:
            img = img + rng.normal(0, noise, img.shape)
        frames[t] = img
    return frames, pd.DataFrame(rows)


class _FirstLaunch:
    """Wraps ``refine.fused_lm_2d`` while the main path runs: counts its
    launches by kind (rigid or not, from the wrapper's own counter) and
    keeps the arguments of the first launch of the kind asked for, to be
    replayed against the plain version afterwards."""

    def __init__(self, rigid):
        self.rigid = rigid
        self.args = self.kw = None
        self.launches = {True: 0, False: 0}
        # _Refit clears it until the recovery pass's joint refit starts
        self.armed = True

    def __enter__(self):
        from clustertracking_tpu_torch import refine
        from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d

        self.orig = refine.fused_lm_2d

        def wrapped(*args, **kw):
            before = fused_lm_2d.launches
            res = self.orig(*args, **kw)
            rigid = kw.get("constraint") is not None
            self.launches[rigid] += fused_lm_2d.launches - before
            if rigid == self.rigid and self.args is None and self.armed:
                self.args, self.kw = args, kw
            return res

        refine.fused_lm_2d = wrapped
        return self

    def __exit__(self, *exc):
        from clustertracking_tpu_torch import refine

        refine.fused_lm_2d = self.orig


def _window_gather_module():
    # the package's ops namespace exports the function under the module's
    # name, so the module itself comes from importlib
    import importlib

    return importlib.import_module(
        "clustertracking_tpu_torch.ops.window_gather")


class _FirstGather:
    """Keeps the arguments of the first window_gather launch while a main
    path runs, to be held against gather_stack afterwards.  It wraps the
    wrapper's ``_launch``, which every launch goes through, so solvers
    built before it took effect are seen too."""

    armed = True

    def __enter__(self):
        wg = _window_gather_module()
        self.args = None
        self.orig = wg._launch

        def launch(frames, frame_idx, origin, window_shape, out):
            if self.args is None and self.armed:
                self.args = (frames, frame_idx.clone(), origin.clone(),
                             tuple(window_shape))
            return self.orig(frames, frame_idx, origin, window_shape, out)

        wg._launch = launch
        return self

    def __exit__(self, *exc):
        _window_gather_module()._launch = self.orig


def _gather_replay(first, what, smi):
    """window_gather bit-equal to gather_stack on a main path's first
    gather (``_FirstGather``), both timed as in [kernel3d].  Returns the
    kernels-line entry without its launches."""
    check(first.args is not None, f"{what}: no window_gather launch to "
          "replay")
    frames, fidx, origin, window = first.args
    g = _gather_cell(frames, fidx, origin, window, GATHER_REPS)
    bound = _bound(g["bytes"], 0)
    print(f"[{what}] {smi}: window_gather on the path's first gather "
          f"(B={len(fidx)}, window {window}), bit-equal to "
          f"gather_stack; L2 flushed before each kernel-alone call: "
          + "; ".join(_fmt_gather(name, g[v], bound["bound_ms"])
                      for v, name in (("kernel", "window_gather"),
                                      ("plain", "gather_stack")))
          + f"; bound {bound['bound_ms']:.5f} ms (bytes)", flush=True)
    return dict(max_abs_err=g["kernel"]["err"], ms=g["kernel"]["call"],
                plain_ms=g["plain"]["call"], **bound,
                library_ms=g["plain"]["call"])


def _lanes(res, keep):
    """The lanes ``keep`` of an LMResult."""
    return type(res)(*(None if v is None else v[keep] for v in res))


def _replay(first, what, smi, cap_by_cost=False):
    """fused_lm_2d vs its plain version on a main path's first launch
    (``_FirstLaunch``): agreement, ms, bound.  Returns the kernels-line
    entry without its launches.  ``cap_by_cost``: lanes that run to the
    iteration cap in either version sit on a flat minimum (a dense
    scene's blended pairs fitted as one feature), where the two roundings
    end at the same cost a few 1e-3 px apart, as ring fits do (ROADMAP
    queue 3, accepted): they are held by cost, the others by every gate."""
    import torch

    from clustertracking_tpu_torch.ops.rigid import rigid_kernel_slots

    check(first.args is not None, f"{what}: no fused_lm_2d launch to replay")
    args, kw = first.args, first.kw
    layout, con = kw["layout"], kw.get("constraint")
    if con is None:
        pos = sorted({int(s) for p in layout.pos_param_idx
                      for s in layout.slot_idx[:, p]})
    else:
        pos = _rigid_positions(layout, con)
        check(rigid_kernel_slots(layout, con)[0] > 0, "not a rigid bucket")
    call, plain = _launcher("fused"), _plain("fused")
    res_p, plain_ms = _timed(lambda: plain(args, kw))
    res_k = call(args, kw)
    torch.cuda.synchronize()
    note, max_err = "", None
    # the bound counts the work of every lane of the launch
    bound = _lm_bound(res_k, args, kw)
    if cap_by_cost:
        cap = ((res_k.n_iter >= kw["max_iter"])
               | (res_p.n_iter >= kw["max_iter"]))
        ck, cp = res_k.cost[cap].cpu().numpy(), res_p.cost[cap].cpu().numpy()
        cap_rel = float(np.max(np.abs(ck - cp) / np.maximum(np.abs(cp),
                                                           1e-30),
                               initial=0.0))
        max_err = float(np.abs(res_k.x.cpu().numpy()[:, pos]
                               - res_p.x.cpu().numpy()[:, pos]).max())
        note = (f"; {int(cap.sum())} lanes ran to the {kw['max_iter']}-"
                f"iteration cap in either version, held by cost only: max "
                f"cost rel {cap_rel:.3e}, max |dpos| of all lanes "
                f"{max_err:.3e} px")
        check(cap_rel <= COST_RTOL, f"{what}: cost disagrees at the cap")
        res_k, res_p = _lanes(res_k, ~cap), _lanes(res_p, ~cap)
    a = _agreement(res_k, res_p, pos)
    ms = _cuda_ms(lambda: call(args, kw), 5)
    print(f"[{what}] {smi}: fused_lm_2d vs plain on the first launch "
          f"(B={len(args[0])}, {len(res_k.cost)} lanes under every gate, "
          f"window {kw['window_shape']}, profile "
          f"{kw['model'].name}{', ' + con.name if con else ''}): {_fmt(a)}"
          f"{note}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; time over "
          f"bound {ms / bound['bound_ms']:.1f}x)", flush=True)
    return dict(max_abs_err=a["pos"] if max_err is None else max_err, ms=ms,
                plain_ms=plain_ms, **bound, library_ms=None)


def phase_train(device, smi):
    """train_leastsq at full frame size, then refine_leastsq with the
    learned coefficients through the inv_series_2 kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from clustertracking_tpu_torch import (
        diagnostics, refine, refine_leastsq, train_leastsq)
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d

    t_phase = time.perf_counter()
    frames, truth = _train_scene()
    kw = dict(diameter=11, separation=6, fit_function="inv_series_2",
              param_mode={"size": "const"}, device=device)
    # first, the same scene with noise σ=1 (not gated): it also takes the
    # process's first-use costs, which the timed call below should not
    noisy, _ = _train_scene(noise=1.0)
    t0 = time.perf_counter()
    learned_n = train_leastsq(truth, noisy, **kw)
    print(f"[train] {smi}: the scene with noise σ=1 (not gated; the first "
          f"call in the process): learned {learned_n} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    calls = []
    orig = refine.lm_solve_global_shards

    def timed(shards, *args, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(shards, *args, **k)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0,
                      max(int(r.n_iter.max()) for r in res),
                      (sum(sh.x0.shape[0] for sh in shards),
                       shards[0].x0.shape[1])))
        return res

    refine.lm_solve_global_shards = timed
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with _FirstGather() as gathered, diagnostics.collect() as stats:
            learned = train_leastsq(truth, frames, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_train = _counts()
    finally:
        refine.lm_solve_global_shards = orig
    tags = sorted({b.backend for b in stats.batches})
    per_round = len({b.cluster_size for b in stats.batches})
    rounds = len(stats.batches) // max(per_round, 1)
    err = [abs(learned[f"coeff_{k + 1}"] - c)
           for k, c in enumerate(TRAIN_COEFFS)]
    ms_call = [1e3 * c[0] for c in calls]
    print(f"[train] {smi}: train_leastsq on {TRAIN_FRAMES} frames of 512x512"
          f" ({len(truth)} features; the first 512 clusters sampled): "
          f"learned {learned}, |error| {err}; {wall:.2f} s, {rounds} rounds "
          f"({wall / max(rounds, 1):.2f} s per round), {tags}; "
          f"lm_solve_global {len(calls)} calls, ms per call "
          f"{[round(m, 1) for m in ms_call]}, max lane n_iter "
          f"{[c[1] for c in calls]}, lanes x slots {[c[2] for c in calls]}; "
          f"launches {n_train}", flush=True)
    check(max(err) < TRAIN_TOL, f"learned coefficients off by {err}")
    kind = torch.device(device).type
    check(tags == [f"{kind}-torch-global"], f"train dispatches took {tags}")
    check(n_train["window_gather"] > 0, "training launched no window_gather")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_leastsq(truth, frames, **kw)
        torch.cuda.synchronize()
    dev = sum(_device_ms(prof).values())
    print(f"[train] {smi}: device busy {dev:.1f} ms of the unprofiled "
          f"{wall * 1e3:.1f} ms: idle share {1.0 - dev / (wall * 1e3):.3f}",
          flush=True)

    # the learned coefficients, held fixed, in every feature's refit
    f0 = truth.copy()
    f0["y"] += 0.3
    f0["x"] -= 0.2
    rkw = dict(diameter=11, separation=6, fit_function="inv_series_2",
               param_mode={"size": "const", "coeff_1": "const",
                           "coeff_2": "const"},
               param_val=learned, device=device)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with _FirstLaunch(rigid=False) as first, diagnostics.collect() as stats:
        out = refine_leastsq(f0, frames, **rkw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts()
    out_p = refine_leastsq(f0, frames, lm_backend="torch", **rkw)
    pos = out[["y", "x"]].to_numpy()
    err = float(np.max(np.hypot(*(pos - truth[["y", "x"]].to_numpy()).T)))
    dpos = float(np.abs(pos - out_p[["y", "x"]].to_numpy()).max())
    tags = sorted({b.backend for b in stats.batches})
    print(f"[train] {smi}: refine_leastsq(param_val=learned) on {len(f0)} "
          f"rows: {wall:.2f} s, {tags}, launches {n}, max |pos - truth| "
          f"{err:.4f} px, max |dpos| vs lm_backend='torch' {dpos:.2e} px, "
          f"accepted {out['cost'].notna().mean():.4f}", flush=True)
    check(n["fused_lm_2d"] > 0, "the refit launched no fused_lm_2d")
    check(tags == [f"{kind}-fused"], f"the refit took {tags}")
    check(err < TRAIN_POS_TOL, f"refit position error {err} px")
    check(dpos <= POS_ATOL, f"kernel and plain routes differ by {dpos} px")
    entry = _replay(first, "train", smi)
    gather = _gather_replay(gathered, "train", smi)
    print(f"[train] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return (dict(launches=n["fused_lm_2d"], **entry),
            dict(launches=n_train["window_gather"] + n["window_gather"],
                 **gather))


def phase_global(frames, truth, raw, device, smi):
    """dimer_global over locate's raw candidates: one bond length for the
    whole video."""
    import torch

    from clustertracking_tpu_torch import (
        diagnostics, dimer_global, find_clusters, refine_leastsq)

    t_phase = time.perf_counter()
    f = find_clusters(raw.copy(), LOC_SEPARATION)
    sizes = f["cluster_size"].value_counts().sort_index().to_dict()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with _FirstLaunch(rigid=True) as first, _FirstGather() as gathered, \
            diagnostics.collect() as stats:
        out = refine_leastsq(f, frames, diameter=LOC_DIAMETER,
                             separation=LOC_SEPARATION,
                             constraints=dimer_global(ndim=2),
                             param_val={"size": LOC_SIZE}, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts()
    tags = sorted({b.backend for b in stats.batches})
    acc = out[(out["cluster_size"] == 2) & out["cost"].notna()]
    pos = acc.sort_values("cluster", kind="stable")[["y", "x"]].to_numpy(
    ).reshape(-1, 2, 2)
    bonds = np.linalg.norm(pos[:, 0] - pos[:, 1], axis=-1)
    d = out.attrs.get("global_dist", float("nan"))
    print(f"[global] {smi}: dimer_global over {LOC_FRAMES} frames "
          f"({len(f)} candidates, cluster sizes {sizes}): {wall:.2f} s "
          f"(per-dispatch fits and the whole-video refit loop), {tags}, "
          f"launches {n} (n-gon {first.launches[True]}, free "
          f"{first.launches[False]}); global_dist {d:.5f} px, "
          f"{len(bonds)} accepted dimers, bond span {np.ptp(bonds):.2e} px, "
          f"accepted {out['cost'].notna().mean():.4f}", flush=True)
    check(first.launches[True] > 0, "no n-gon fused_lm_2d launch")
    check(np.ptp(bonds) < GLOBAL_PTP_TOL, f"bonds span {np.ptp(bonds)} px")
    check(abs(d - LOC_BOND) < GLOBAL_DIST_TOL, f"global_dist {d} px")
    check(n["window_gather"] > 0, "dimer_global launched no window_gather")
    entry = _replay(first, "global", smi)
    gather = _gather_replay(gathered, "global", smi)
    print(f"[global] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return (dict(launches=first.launches[True], **entry),
            dict(launches=n["window_gather"], **gather))


def _min_index_labels(labels):
    """Each point's smallest index in its component: the raw labels the
    label propagation converges to on that partition."""
    _, inv = np.unique(labels, return_inverse=True)
    first = np.full(inv.max() + 1 if len(inv) else 0, len(labels))
    np.minimum.at(first, inv, np.arange(len(labels)))
    return first[inv]


def _exact_labels(coords, sep):
    """Root labels of the "distance <= sep" graph with every candidate
    pair decided in exact rational arithmetic, and the number of pairs on
    which the host's float test (cKDTree over coords / sep) decides
    otherwise."""
    from fractions import Fraction

    from scipy.spatial import cKDTree

    host_pairs = cKDTree(coords / sep).query_pairs(1.0)
    s2 = Fraction(sep) ** 2
    parent = np.arange(len(coords))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    differ = 0
    for i, j in cKDTree(coords).query_pairs(sep * (1 + 1e-9)):
        d2 = sum((Fraction(a) - Fraction(b)) ** 2
                 for a, b in zip(coords[i], coords[j]))
        near = d2 <= s2
        differ += near != ((i, j) in host_pairs)
        if near:
            ri, rj = find(i), find(j)
            parent[max(ri, rj)] = min(ri, rj)
    return np.array([find(i) for i in range(len(coords))]), differ


def _median_ms(fn, reps, sync=None):
    """Median wall ms of ``reps`` calls (after one untimed call)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if sync is not None:
            sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_find(c5_frame0, device, smi):
    """Device cluster finding (label propagation, float64) at separation
    6 against the exact partition, the CPU and the host's cKDTree +
    union-find, and timed against the host: config 5's first frame of
    candidates, uniform points at config 5's density, a long chain."""
    import torch

    from clustertracking_tpu_torch.find import (
        _canonicalize, _labels_device, host_connected_components)
    from clustertracking_tpu_torch.ops.find import _block_rows
    from clustertracking_tpu_torch.ops.find import (
        connected_components as cc)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(8)
    sets = {"config 5 frame 0": c5_frame0}
    for n in FIND_NS:
        side = np.sqrt(n / FIND_DENSITY)
        sets[f"uniform N={n}"] = rng.uniform(0, side, (n, 2))
    # spacing 5 at separation 6: each point joins its two neighbours only
    sets["chain N=1000"] = np.stack([np.zeros(1000), np.arange(1000) * 5.0],
                                    axis=-1)
    times = {}
    for name, coords in sets.items():
        N = len(coords)
        host = host_connected_components(coords, FIND_SEP)
        exact, misjudged = _exact_labels(coords, FIND_SEP)
        card = _labels_device(coords, FIND_SEP, device)
        rounds = cc.last_rounds
        check(np.array_equal(card, _min_index_labels(exact)),
              f"find {name}: the card's labels are not the exact partition's "
              "least indices")
        # the host's float test rounds coords / sep first, so it can leave
        # out a pair at exactly the separation (integer candidates)
        same_host = np.array_equal(_canonicalize(card), _canonicalize(host))
        check(same_host or misjudged,
              f"find {name}: the card's clusters differ from the host's")
        if N <= FIND_CPU_MAX:
            cpu = _labels_device(coords, FIND_SEP, "cpu")
            check(np.array_equal(card, cpu),
                  f"find {name}: card and CPU raw labels differ")
            raw_vs = "the CPU propagation's"
        else:
            raw_vs = f"(no CPU run above N = {FIND_CPU_MAX:,})"
        host_ms = _median_ms(
            lambda: host_connected_components(coords, FIND_SEP), FIND_REPS)
        card_ms = _median_ms(
            lambda: _labels_device(coords, FIND_SEP, device), FIND_REPS,
            torch.cuda.synchronize)
        times[name] = (host_ms, card_ms)
        print(f"[find] {smi}: {name}: {len(set(exact.tolist()))} clusters; "
              f"card labels equal the exact partition's least indices and "
              f"{raw_vs} raw; "
              f"the host's {len(set(host.tolist()))} clusters "
              f"{'equal them' if same_host else 'differ'} ({misjudged} pairs "
              f"at the separation that the host's float test decides "
              f"otherwise); "
              f"{rounds} propagation rounds, {_block_rows(N)} rows a block; "
              f"host {host_ms:.2f} ms, card {card_ms:.2f} ms (median of "
              f"{FIND_REPS}, coordinates in and labels out included)",
              flush=True)
    faster = [n for n in FIND_NS
              if times[f"uniform N={n}"][1] < times[f"uniform N={n}"][0]]
    print(f"[find] {smi}: the card is faster than the host at uniform N in "
          f"{faster} (of {list(FIND_NS)}); 'auto' keeps the reference's "
          f"threshold of 100,000; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _partition(ids):
    """Ids relabelled in order of first appearance: equal arrays mean the
    same partition of the rows."""
    _, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv]


def _rows_in_identical_trajectories(p1, p2):
    """Rows whose trajectory (the rows sharing their id) is the same set
    under both labelings."""
    def groups(p):
        rows = {}
        for i, pid in enumerate(p.tolist()):
            rows.setdefault(pid, []).append(i)
        return [tuple(rows[pid]) for pid in p.tolist()]

    return sum(a == b for a, b in zip(groups(p1), groups(p2)))


def _linker_stats(backend):
    from clustertracking_tpu_torch.ops.link import (
        link_on_device, link_on_device_binned)

    st = (link_on_device if backend == "device"
          else link_on_device_binned).last_stats
    return (f"rounds per frame mean {np.mean(st['rounds']):.2f} max "
            f"{max(st['rounds'])}, host syncs per frame mean "
            f"{np.mean(st['syncs']):.2f} max {max(st['syncs'])}")


def phase_link(c2_truth, c5_truth, device, smi):
    """The host Linker, the dense auction and the binned auction on the
    truth rows of config 2 (100 frames x 100 features, memory 6) and
    config 5 (4 frames x 10,000, memory 2), search range 3."""
    import torch

    from clustertracking_tpu_torch import link

    t_phase = time.perf_counter()
    scenes = (("config 2", c2_truth, 6, "device"),
              ("config 5", c5_truth, 2, "device-binned"))
    for name, truth, memory, want in scenes:
        f = truth[["frame", "y", "x"]].reset_index(drop=True)
        T = int(f["frame"].nunique())
        kw = dict(memory=memory)

        def timed(frame_rows, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = link(frame_rows, 3.0, **kw, **k)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        auto = link(f, 3.0, backend="auto", device=device, **kw)
        check(auto.attrs["link_backend"] == want,
              f"{name}: 'auto' took {auto.attrs['link_backend']}")
        host, host_ms = timed(f, backend="host")
        card, card_ms = timed(f, backend=want, device=device)
        card_stats = _linker_stats(want)
        cpu = link(f, 3.0, backend=want, device="cpu", **kw)
        check(np.array_equal(card["particle"].to_numpy(),
                             cpu["particle"].to_numpy()),
              f"{name}: {want} on the card and on the CPU differ")
        check(np.array_equal(card["particle"].to_numpy(),
                             auto["particle"].to_numpy()),
              f"{name}: 'auto' and {want} differ")
        same = _rows_in_identical_trajectories(card["particle"].to_numpy(),
                                               host["particle"].to_numpy())
        other = "device-binned" if want == "device" else "device"
        rows = f if want == "device" else f[f["frame"] < 2]
        T_other = int(rows["frame"].nunique())
        link(rows, 3.0, backend=other, device=device, **kw)   # warm-up
        _, other_ms = timed(rows, backend=other, device=device)
        print(f"[link] {smi}: {name} truth, {T} frames x "
              f"{len(f) // T} features, memory {memory}: 'auto' takes "
              f"{want}; ms per frame: host {host_ms / T:.2f}, {want} "
              f"{card_ms / T:.2f} ({card_stats}), {other} "
              f"{other_ms / T_other:.2f} over {T_other} frames "
              f"({_linker_stats(other)}); {want} equals the CPU's particle "
              f"for particle; {same} of {len(f)} rows in trajectories "
              f"identical to the host Linker's ({len(f) - same} differ); "
              f"trajectories: host {host['particle'].nunique()}, {want} "
              f"{card['particle'].nunique()}", flush=True)
        if want == "device":
            check(np.array_equal(_partition(card["particle"].to_numpy()),
                                 _partition(host["particle"].to_numpy())),
                  f"{name}: the auction's trajectories differ from the host "
                  "Linker's")
        else:
            check(same >= LINK_AGREE * len(f),
                  f"{name}: {len(f) - same} rows in trajectories that differ "
                  "from the host Linker's")
    print(f"[link] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _track_accuracy(out, truth):
    """(median position error of tracked rows within 1 px of a truth
    feature of their frame, share of truth feature-frames with a tracked
    row within 1 px, median error of the members of resolved dimers: both
    members tracked, by two distinct rows).  _video()'s truth rows come in
    dimers, rows 2i and 2i + 1."""
    from scipy.spatial import cKDTree

    errs, pair_errs, hit = [], [], 0
    for t, tr in truth.groupby("frame", sort=True):
        o = out[out["frame"] == t][["y", "x"]].to_numpy()
        want = tr[["y", "x"]].to_numpy()
        if not len(o):
            continue
        d, _ = cKDTree(want).query(o, k=1)
        errs.append(d[d < 1.0])
        d2, j = cKDTree(o).query(want, k=1)
        hit += int((d2 < 1.0).sum())
        d2, j = d2.reshape(-1, 2), j.reshape(-1, 2)
        ok = (d2 < 1.0).all(axis=1) & (j[:, 0] != j[:, 1])
        pair_errs.append(d2[ok].ravel())
    return (float(np.median(np.concatenate(errs))), hit / len(truth),
            float(np.median(np.concatenate(pair_errs))))


def _ledger(stats):
    return ", ".join(f"{k} {v}" for k, v in stats.ledger.items())


def _by_tag(stats):
    """Dispatches, clusters and seconds of the fit by backend tag."""
    out = {}
    for b in stats.batches:
        d = out.setdefault(b.backend, [0, 0, 0.0])
        d[0] += 1
        d[1] += b.n_clusters
        d[2] += b.wall_s
    return "; ".join(f"{k}: {n} dispatches, {c} clusters, {w:.3f} s"
                     for k, (n, c, w) in sorted(out.items()))


def _same_tracks(a, b, atol, capped_by_decisions=False):
    """The same rows in the same order, the same trajectory and cluster
    partitions, positions within ``atol`` px.  With
    ``capped_by_decisions`` (runs with recovery passes), rows whose fit
    did not converge in either run are the joint refit's lanes stopped
    mid-descent at its 16-iteration cap (by design), where two roundings
    of the same descent (the card's kernels and PyTorch's CPU ops) part by
    more than rounding: they are held by the decisions they feed, the rows
    kept and the partitions (and, by the caller, the ledger's counts), and
    their differences reported.  Returns (max |dpos| of the rows held by
    ``atol``, max |dpos| of the capped ones, their max cost relative
    difference, their count)."""
    check(len(a) == len(b) and np.array_equal(a["frame"].to_numpy(),
                                             b["frame"].to_numpy()),
          f"{len(a)} rows against {len(b)}")
    capped = np.zeros(len(a), bool)
    if capped_by_decisions:
        capped = ~(a["fit_converged"].to_numpy(bool)
                   & b["fit_converged"].to_numpy(bool))
    d = np.abs(a[["y", "x"]].to_numpy() - b[["y", "x"]].to_numpy()).max(
        axis=1) if len(a) else np.zeros(0)
    d_ok = float(d[~capped].max(initial=0.0))
    d_cap = float(d[capped].max(initial=0.0))
    check(d_ok <= atol, f"positions differ by {d_ok} px")
    ca, cb = a["cost"].to_numpy()[capped], b["cost"].to_numpy()[capped]
    rel = float(np.max(np.abs(ca - cb) / np.maximum(np.abs(cb), 1e-30),
                       initial=0.0))
    for col in ("particle", "cluster"):
        check(np.array_equal(_partition(a[col].to_numpy()),
                             _partition(b[col].to_numpy())),
              f"the {col} partitions differ")
    return d_ok, d_cap, rel, int(capped.sum())


def phase_track(frames, truth, device, smi):
    """Config 2 through track (benchmarks/suite.py::config2's kwargs), the
    kernel route against the CPU on 8 frames, and checkpoint + resume
    against the single-shot host-linked run."""
    import tempfile

    import torch

    from clustertracking_tpu_torch import diagnostics, motion, track

    t_phase = time.perf_counter()
    reader = _Stack(frames)
    T = len(frames)
    track(reader, device=device, **TRACK_KW)     # untimed: first-use costs
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with _FirstLaunch(rigid=False) as first, diagnostics.collect() as stats:
        out = track(reader, device=device, **TRACK_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts()
    err, recall, pair_err = _track_accuracy(out, truth)
    lengths = out.groupby("particle").size()
    est = motion.diffusion_constants(out)
    print(f"[track] {smi}: config 2, {T} frames of {frames.shape[1]}x"
          f"{frames.shape[2]}: {T / wall:.2f} frames/s ({wall:.3f} s); "
          f"ledger: {_ledger(stats)}; launches {n}; {len(out)} rows, "
          f"median |pos - truth| {err:.4f} px, recall within 1 px "
          f"{recall:.4f}; {out['particle'].nunique()} trajectories, "
          f"{int((lengths >= 10).sum())} of 10 frames or more; median error "
          f"of resolved dimers' members {pair_err:.4f} px; "
          f"D_trans {est['D_trans']:.4f} ± {est['D_trans_std']:.4f} "
          f"px²/frame (truth {D_TRUTH[0]}), D_rot {est['D_rot']:.5f} ± "
          f"{est['D_rot_std']:.5f} rad²/frame (truth {D_TRUTH[1]}; not "
          f"gated)", flush=True)
    check(out.attrs["link_backend"] == "device",
          f"track linked with {out.attrs['link_backend']}")
    check(n["fused_lm_2d"] > 0, "track launched no fused_lm_2d")
    check(err < TRACK_ERR, f"track median position error {err} px")
    check(recall >= TRACK_RECALL, f"track recall {recall}")

    few = _Stack(frames[:TRACK_CPU_FRAMES])
    on_card = track(few, device=device, **TRACK_KW)
    t0 = time.perf_counter()
    on_cpu = track(few, device="cpu", **TRACK_KW)
    cpu_s = time.perf_counter() - t0
    dpos = _same_tracks(on_card, on_cpu, TRACK_POS_ATOL)[0]
    print(f"[track] {smi}: the first {TRACK_CPU_FRAMES} frames on the card "
          f"and on the CPU ({cpu_s:.2f} s): {len(on_card)} rows alike, the "
          f"same trajectories and clusters, max |dpos| {dpos:.2e} px (tol "
          f"{TRACK_POS_ATOL})", flush=True)

    ckw = {k: v for k, v in TRACK_KW.items() if k != "link_backend"}
    single = track(reader, link_backend="host", device=device, **ckw)
    with tempfile.TemporaryDirectory() as ck:
        track(reader, checkpoint_dir=ck, checkpoint_every=16, n_frames=32,
              device=device, **ckw)
        t0 = time.perf_counter()
        resumed = track(reader, checkpoint_dir=ck, checkpoint_every=16,
                        device=device, **ckw)
        resume_s = time.perf_counter() - t0
    key = ["frame", "y", "x"]
    a = resumed.sort_values(key).reset_index(drop=True)
    b = single.sort_values(key).reset_index(drop=True)
    check(len(a) == len(b), f"resumed {len(a)} rows, single-shot {len(b)}")
    dpos = float(np.abs(a[["y", "x"]].to_numpy()
                        - b[["y", "x"]].to_numpy()).max())
    check(dpos <= CKPT_POS_ATOL, f"resumed rows off by {dpos} px")
    check(np.array_equal(a["particle"].to_numpy(), b["particle"].to_numpy()),
          "resumed particle ids differ from the single-shot run's")
    print(f"[track] {smi}: checkpointed every 16 frames, stopped after 32, "
          f"resumed ({resume_s:.2f} s for the last {T - 32} frames): "
          f"{len(a)} rows, particle ids equal to the single-shot host-linked"
          f" run's, max |dpos| {dpos:.2e} px (tol {CKPT_POS_ATOL})",
          flush=True)
    entry = _replay(first, "track", smi)
    print(f"[track] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(launches=n["fused_lm_2d"], **entry)


def phase_track5(frames, truth, device, smi):
    """Config 5 through track (benchmarks/suite.py::config5's kwargs):
    the binned auction, fused_lm_2d for the small clusters, window_gather
    and lm_solve for the chains past the kernel's slots."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from clustertracking_tpu_torch import diagnostics, track

    t_phase = time.perf_counter()
    reader = _Stack(frames)
    T = len(frames)
    track(reader, device=device, **TRACK5_KW)    # untimed: first-use costs
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with _FirstLaunch(rigid=False) as first, _FirstGather() as gathered, \
            diagnostics.collect() as stats:
        out = track(reader, device=device, **TRACK5_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts()
    err, recall, pair_err = _track_accuracy(out, truth)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        track(reader, device=device, **TRACK5_KW)
        torch.cuda.synchronize()
    dev = sum(_device_ms(prof).values())
    prof_s = time.perf_counter() - t0
    sizes = out["cluster_size"].value_counts().sort_index().to_dict()
    print(f"[track5] {smi}: config 5, {T} frames of {frames.shape[1]}x"
          f"{frames.shape[2]}, {len(truth) // T} features a frame: "
          f"{T / wall:.3f} frames/s ({wall:.3f} s); ledger: {_ledger(stats)};"
          f" launches {n}; by tag: {_by_tag(stats)}; cluster sizes "
          f"{sizes}; {len(out)} rows, median |pos - truth| {err:.4f} px, "
          f"of resolved dimers' members {pair_err:.4f} px, "
          f"recall within 1 px {recall:.4f}, {out['particle'].nunique()} "
          f"trajectories; device busy {dev:.1f} ms: idle share "
          f"{1.0 - dev / (wall * 1e3):.3f} of the unprofiled call (the "
          f"profiled call and its trace {prof_s:.1f} s)", flush=True)
    check(out.attrs["link_backend"] == "device-binned",
          f"config 5 linked with {out.attrs['link_backend']}")
    check(n["fused_lm_2d"] > 0, "config 5 launched no fused_lm_2d")
    check(n["window_gather"] > 0, "config 5 launched no window_gather")
    check(err < TRACK5_ERR, f"config 5 median position error {err} px")
    entry = _replay(first, "track5", smi, cap_by_cost=True)
    gather = _gather_replay(gathered, "track5", smi)
    print(f"[track5] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return (dict(launches=n["fused_lm_2d"], **entry),
            dict(launches=n["window_gather"], **gather))


def _recovery_score(out, truth, n_frames):
    """benchmarks/recovery_exp.py::score, in numpy: a truth feature is
    tracked when an output of its frame lies within 1 px, an output is a
    ghost when no truth feature of its frame lies within 1.5 px.  Returns
    (coverage, ghosts, outputs, median error of tracked features, px)."""
    from scipy.spatial import cKDTree

    tracked = total = ghosts = n_out = 0
    err = []
    for t in range(n_frames):
        tr = truth[truth["frame"] == t][["y", "x"]].to_numpy()
        ot = out[(out["frame"] == t) & out["cost"].notna()][
            ["y", "x"]].to_numpy()
        total += len(tr)
        n_out += len(ot)
        if not len(ot):
            continue
        d, _ = cKDTree(ot).query(tr, k=1)
        tracked += int((d < 1.0).sum())
        err.extend(d[d < 1.0].tolist())
        d2, _ = cKDTree(tr).query(ot, k=1)
        ghosts += int((d2 > 1.5).sum())
    return (tracked / total, ghosts, n_out,
            float(np.median(err)) if err else float("nan"))


def _ledger_counts(stats):
    """The ledger's counts (its stage walls, the ``*_s`` keys, left out)."""
    return {k: v for k, v in stats.ledger.items() if not k.endswith("_s")}


def _walls(stats):
    return ", ".join(f"{k} {v}" for k, v in stats.ledger.items()
                     if k.endswith("_s"))


class _Refit:
    """Clears the first-launch captures (``_FirstLaunch``,
    ``_FirstGather``) during a track call's first refine_leastsq (the main
    fit) and arms them from its second on: the recovery pass's joint
    refit."""

    def __init__(self, *captures):
        self.captures = captures

    def __enter__(self):
        from clustertracking_tpu_torch import pipeline

        self.orig = pipeline.refine_leastsq
        self.calls = 0
        for c in self.captures:
            c.armed = False

        def wrapped(*args, **kw):
            self.calls += 1
            for c in self.captures:
                c.armed = self.calls > 1
            return self.orig(*args, **kw)

        pipeline.refine_leastsq = wrapped
        return self

    def __exit__(self, *exc):
        from clustertracking_tpu_torch import pipeline

        pipeline.refine_leastsq = self.orig


def _reach(truth, T):
    """The most features of one frame within SYNTH_REACH px of one pixel:
    a disc count over each frame's histogram of feature pixels."""
    from scipy.signal import fftconvolve

    r = int(np.ceil(SYNTH_REACH))
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    disc = ((yy ** 2 + xx ** 2) <= (SYNTH_REACH + 1.0) ** 2).astype(float)
    most = 0
    for t in range(T):
        ft = truth[truth["frame"] == t]
        h = np.zeros(C5_SHAPE)
        iy = np.clip(np.floor(ft["y"].to_numpy()).astype(int), 0,
                     C5_SHAPE[0] - 1)
        ix = np.clip(np.floor(ft["x"].to_numpy()).astype(int), 0,
                     C5_SHAPE[1] - 1)
        np.add.at(h, (iy, ix), 1.0)
        most = max(most, int(np.rint(fftconvolve(h, disc, "same").max())))
    return most


def phase_synth(truth, device, smi):
    """frames_from_df at config 5's size on the card: against the same
    call on the CPU and against artificial.CoordinateReader, two renders
    bit-equal, ms per frame, and the noise's statistics."""
    import torch

    from clustertracking_tpu_torch.artificial import CoordinateReader
    from clustertracking_tpu_torch.ops.synth import frames_from_df

    t_phase = time.perf_counter()
    T = int(truth["frame"].max()) + 1

    def render(**kw):
        return frames_from_df(truth, C5_SHAPE, LOC_SIZE, **kw)

    card = render(device=device)
    again = render(device=device)
    torch.cuda.synchronize()
    same = bool(torch.equal(card, again))
    ms = _cuda_ms(lambda: render(device=device), SYNTH_REPS) / T
    t0 = time.perf_counter()
    cpu = render(device="cpu")
    cpu_s = time.perf_counter() - t0
    sig = float(truth["signal"].max())
    err_cpu = float((card.cpu() - cpu).abs().max())
    # CoordinateReader evaluates each feature out to 5σ, the render on a
    # window of ceil(10σ) + 1 px from floor(pos) - window // 2: the two
    # part only on pixels 5σ or more from a feature, where it is at most
    # signal·exp(-12.5), and in a frame this crowded a pixel lies that
    # far from several features at once
    reader = CoordinateReader(truth, C5_SHAPE, size=LOC_SIZE)
    diff = np.stack([np.abs(card[t].cpu().numpy() - reader[t])
                     for t in range(T)])
    err_host = float(diff.max())
    over = float((diff >= SYNTH_TAIL).mean())
    tail_bound = sig * np.exp(-12.5) * _reach(truth, T)
    noise = (render(device=device, noise_level=LOC_NOISE, seed=C5_SEED)
             - card).cpu().numpy()
    print(f"[synth] {smi}: frames_from_df, {T} frames of {C5_SHAPE[0]}x"
          f"{C5_SHAPE[1]}, {len(truth) // T} features a frame: "
          f"{ms:.3f} ms per frame on the card (CPU {cpu_s * 1e3 / T:.1f} ms "
          f"per frame); two renders bit-equal {same}; max |card - CPU| "
          f"{err_cpu:.3e} (tol {SYNTH_ATOL} x signal {sig}); max |card - "
          f"CoordinateReader| {err_host:.3e} (bound {tail_bound:.3e}: "
          f"signal·exp(-12.5) × the most features one pixel reaches; "
          f"{over:.2e} of the pixels at {SYNTH_TAIL} or more); noise "
          f"σ={LOC_NOISE}: mean {noise.mean():.2e}, std {noise.std():.5f}",
          flush=True)
    check(same, "two renders of one table differ")
    check(err_cpu <= SYNTH_ATOL * sig, f"card render off the CPU's by "
          f"{err_cpu}")
    check(err_host <= tail_bound, f"card render off CoordinateReader by "
          f"{err_host}")
    check(abs(noise.std() - LOC_NOISE) < 0.01 * LOC_NOISE,
          f"noise std {noise.std()}")
    print(f"[synth] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def phase_track_r(frames, truth, device, smi):
    """Config 2 through track with recover_passes=1, then with
    transfer_dtype='float16' (benchmarks/suite.py::config2's variants);
    8 frames with the recovery pass on the card against the CPU; the
    checkpointed recovery run against the single-shot host-linked one."""
    import tempfile

    import torch

    from clustertracking_tpu_torch import diagnostics, track

    t_phase = time.perf_counter()
    reader = _Stack(frames)
    T = len(frames)
    kw = dict(TRACK_KW, recover_passes=1)
    track(reader, device=device, **kw)     # untimed: first-use costs
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with _FirstLaunch(rigid=False) as first, _Refit(first), \
            diagnostics.collect() as stats:
        out = track(reader, device=device, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts()
    err, recall, pair_err = _track_accuracy(out, truth)
    print(f"[track_r] {smi}: config 2, recover_passes=1: {T / wall:.2f} "
          f"frames/s ({wall:.3f} s); ledger: {_ledger(stats)}; launches "
          f"{n}; {len(out)} rows, {out['particle'].nunique()} trajectories; "
          f"median |pos - truth| {err:.4f} px, recall within 1 px "
          f"{recall:.4f}, median error of resolved dimers' members "
          f"{pair_err:.4f} px", flush=True)
    check("residual_candidates" in stats.ledger, "no recovery pass ran")
    check(err < TRACK_ERR, f"track_r median position error {err} px")
    check(recall >= TRACK_RECALL, f"track_r recall {recall}")

    kw16 = dict(TRACK_KW, transfer_dtype="float16")
    track(reader, device=device, **kw16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with diagnostics.collect() as s16:
        out16 = track(reader, device=device, **kw16)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    err16, recall16, _ = _track_accuracy(out16, truth)
    print(f"[track_r] {smi}: config 2, transfer_dtype='float16': "
          f"{T / wall16:.2f} frames/s ({wall16:.3f} s); stage walls "
          f"{_walls(s16)}; {len(out16)} rows, {out16['particle'].nunique()} "
          f"trajectories; median |pos - truth| {err16:.4f} px, recall "
          f"{recall16:.4f}", flush=True)
    check(err16 < TRACK_ERR, f"float16 transfer median error {err16} px")
    check(recall16 >= TRACK_RECALL, f"float16 transfer recall {recall16}")

    few = _Stack(frames[:TRACK_CPU_FRAMES])
    with diagnostics.collect() as s_card:
        on_card = track(few, device=device, **kw)
    t0 = time.perf_counter()
    with diagnostics.collect() as s_cpu:
        on_cpu = track(few, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    d_ok, d_cap, rel_cap, n_cap = _same_tracks(
        on_card, on_cpu, TRACK_POS_ATOL, capped_by_decisions=True)
    # the counts up to the refit, and the rows kept, are held equal; the
    # accept stage's attribution reads the refit's unfinished costs
    # against its thresholds, so a capped lane near one (0.9 × the old
    # rms, the signal floors) can fall to another gate: reported
    led_card, led_cpu = _ledger_counts(s_card), _ledger_counts(s_cpu)
    pre = {k: v for k, v in led_card.items() if k not in ACCEPT_KEYS}
    check(pre == {k: v for k, v in led_cpu.items() if k not in ACCEPT_KEYS},
          f"ledgers differ before the accept stage: {led_card} against "
          f"{led_cpu}")
    moved = {k: (led_card.get(k, 0), led_cpu.get(k, 0)) for k in ACCEPT_KEYS
             if led_card.get(k, 0) != led_cpu.get(k, 0)}
    print(f"[track_r] {smi}: the first {TRACK_CPU_FRAMES} frames with "
          f"recover_passes=1 on the card and on the CPU ({cpu_s:.2f} s): "
          f"{len(on_card)} rows alike, the same trajectories, clusters and "
          f"ledger counts up to the accept stage; accept-stage counts that "
          f"differ (card, CPU): {moved or 'none'}; max |dpos| {d_ok:.2e} px "
          f"(tol {TRACK_POS_ATOL}); "
          f"{n_cap} rows unconverged (the refit's iteration cap), held by "
          f"the decisions: max |dpos| {d_cap:.2e} px, max cost rel "
          f"{rel_cap:.2e}", flush=True)

    ckw = {k: v for k, v in kw.items() if k != "link_backend"}
    head = _Stack(frames[:CKPT_FRAMES])
    key = ["frame", "y", "x"]

    def rows(df):
        return df.sort_values(key).reset_index(drop=True)

    single = rows(track(head, link_backend="host", device=device, **ckw))
    with tempfile.TemporaryDirectory() as c1, \
            tempfile.TemporaryDirectory() as c2, \
            tempfile.TemporaryDirectory() as c3:
        whole = rows(track(head, checkpoint_dir=c1,
                           checkpoint_every=CKPT_FRAMES, device=device,
                           **ckw))
        chunked = rows(track(head, checkpoint_dir=c2, checkpoint_every=16,
                             device=device, **ckw))
        track(head, checkpoint_dir=c3, checkpoint_every=16, n_frames=16,
              device=device, **ckw)
        t0 = time.perf_counter()
        resumed = rows(track(head, checkpoint_dir=c3, checkpoint_every=16,
                             device=device, **ckw))
        resume_s = time.perf_counter() - t0
    for name, got, want in (("one chunk", whole, single),
                            ("resumed", resumed, chunked)):
        check(len(got) == len(want), f"{name}: {len(got)} rows against "
              f"{len(want)}")
        dpos = float(np.abs(got[["y", "x"]].to_numpy()
                            - want[["y", "x"]].to_numpy()).max())
        check(dpos <= CKPT_POS_ATOL, f"{name}: rows off by {dpos} px")
        check(np.array_equal(got["particle"].to_numpy(),
                             want["particle"].to_numpy()),
              f"{name}: particle ids differ")
    a = {tuple(np.round(r, 5)) for r in chunked[key].to_numpy()}
    b = {tuple(np.round(r, 5)) for r in single[key].to_numpy()}
    print(f"[track_r] {smi}: checkpointed with recover_passes=1 on the "
          f"first {CKPT_FRAMES} frames: one {CKPT_FRAMES}-frame chunk = "
          f"the single-shot host-linked run ({len(single)} rows, particle "
          f"ids and positions equal); 16-frame chunks stopped after 16 and "
          f"resumed ({resume_s:.2f} s) = the uninterrupted 16-frame-chunk "
          f"run; that run (recovery statistics per chunk) shares "
          f"{len(a & b)} of {len(b)} rows with the single-shot one to "
          f"1e-5 px", flush=True)
    entry = _replay(first, "track_r", smi, cap_by_cost=True)
    print(f"[track_r] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(launches=n["fused_lm_2d"], **entry)


def phase_track5r(frames, truth, device, smi):
    """Config 5 through track with recover_passes=1, scored as
    benchmarks/recovery_exp.py scores it, against the reference's own
    one-pass accuracy (benchmarks/RESULTS.md:97); both kernels against
    their plain versions on the recovery refit's first launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from clustertracking_tpu_torch import diagnostics, track

    t_phase = time.perf_counter()
    reader = _Stack(frames)
    T = len(frames)
    kw = dict(TRACK5_KW, recover_passes=1)
    _reset_counts()
    t0 = time.perf_counter()
    with _FirstLaunch(rigid=False) as first, _FirstGather() as gathered, \
            _Refit(first, gathered) as refit, \
            diagnostics.collect() as stats:
        out = track(reader, device=device, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _counts()
    cov, ghosts, n_out, med = _recovery_score(out, truth, T)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        track(reader, device=device, **kw)
        torch.cuda.synchronize()
    dev = sum(_device_ms(prof).values())
    prof_s = time.perf_counter() - t0
    by_backend = {k: {kk: round(vv, 3) for kk, vv in v.items()}
                  for k, v in stats.summary_by_backend().items()}
    print(f"[track5r] {smi}: config 5, recover_passes=1, {T} frames of "
          f"{frames.shape[1]}x{frames.shape[2]}: {T / wall:.3f} frames/s "
          f"({wall:.3f} s); coverage {cov:.4f} (gate {TRACK5R_COVERAGE}), "
          f"ghosts {ghosts} = {ghosts / n_out:.4f} of {n_out} outputs (gate "
          f"{TRACK5R_GHOSTS}), median error {med:.4f} px (gate "
          f"{TRACK5R_ERR}); refine_leastsq calls {refit.calls}", flush=True)
    print(f"[track5r] {smi}: ledger counts {_ledger_counts(stats)}; stage "
          f"walls {_walls(stats)}", flush=True)
    print(f"[track5r] {smi}: launches {n}; summary_by_backend "
          f"{json.dumps(by_backend)}; device busy {dev:.1f} ms: idle share "
          f"{1.0 - dev / (wall * 1e3):.3f} of the unprofiled call (the "
          f"profiled call and its trace {prof_s:.1f} s)", flush=True)
    check(n["fused_lm_2d"] > 0, "track5r launched no fused_lm_2d")
    check(n["window_gather"] > 0, "track5r launched no window_gather")
    check(cov >= TRACK5R_COVERAGE, f"config 5 coverage {cov}")
    check(ghosts <= TRACK5R_GHOSTS * n_out, f"config 5 ghosts {ghosts}")
    check(med <= TRACK5R_ERR, f"config 5 median error {med} px")
    entry = _replay(first, "track5r", smi, cap_by_cost=True)
    gather = _gather_replay(gathered, "track5r", smi)
    print(f"[track5r] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return (dict(launches=n["fused_lm_2d"], **entry),
            dict(launches=n["window_gather"], **gather))


def phase_trace(frames, device, smi):
    """diagnostics.trace_to around one config 2 track call: the trace file
    it writes holds the stage ranges and the card's kernels."""
    import tempfile
    from pathlib import Path

    import torch

    from clustertracking_tpu_torch import diagnostics, track

    t_phase = time.perf_counter()
    reader = _Stack(frames)
    with tempfile.TemporaryDirectory() as d:
        with diagnostics.trace_to(d):
            track(reader, device=device, **TRACK_KW)
            torch.cuda.synchronize()
        files = sorted(Path(d).glob("*.pt.trace.json*"))
        check(len(files) == 1, f"trace_to wrote {len(files)} trace files")
        size = files[0].stat().st_size
        events = json.loads(files[0].read_text())["traceEvents"]
    names = {}
    kernels = 0
    for e in events:
        nm = str(e.get("name", ""))
        if nm.startswith(("fit_bucket_n", "refit_round_")):
            key = nm.rstrip("0123456789")
            names[key] = names.get(key, 0) + 1
        if e.get("cat") == "kernel":
            kernels += 1
    print(f"[trace] {smi}: trace_to around config 2's track: one file, "
          f"{size / 1e6:.1f} MB, {len(events)} events, {kernels} device "
          f"kernels; stage ranges {names}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(names.get("fit_bucket_n", 0) > 0 and names.get("refit_round_", 0)
          > 0, "the trace holds no stage ranges")
    check(kernels > 0, "the trace holds no device kernels")


_T0 = time.perf_counter()


def _stamp(phase):
    print(f"[time] {phase} done at {time.perf_counter() - _T0:.1f} s",
          flush=True)


MESH_SHARDS = 4        # [mesh]'s shards, on the visible cards in turn
MESH_PTP = 1e-5        # the tied slot's spread over every lane of every shard
MESH_TIE_RTOL = 1e-4   # the tied values against one device's
                       # (tests/test_sharded_api.py's tolerance)
MESH_COLS = ("y", "x", "signal", "size", "cost", "fit_converged",
             "fit_n_iter")


def _mesh():
    """MESH_SHARDS shards on the visible cards in turn."""
    import torch

    from clustertracking_tpu_torch.parallel.sharding import make_mesh

    n = torch.cuda.device_count()
    return make_mesh([torch.device("cuda", s % n)
                      for s in range(MESH_SHARDS)])


def _bit_equal(a, b, cols):
    """The columns of ``cols`` equal bit for bit (NaN equal to NaN)."""
    return (len(a) == len(b) and all(
        np.array_equal(a[c].to_numpy(), b[c].to_numpy(),
                       equal_nan=a[c].dtype.kind == "f")
        for c in cols if c in b.columns))


def _tally(acc):
    """Add the wrappers' counts to ``acc`` and set them to 0."""
    for k, v in _counts().items():
        acc[k] = acc.get(k, 0) + v
    _reset_counts()


class _FirstPixel:
    """Wraps ``refine.pixel_lm`` while a main path runs: keeps the
    arguments of its first launch in each mode ('resident', 'streamed'),
    to be replayed against the plain version afterwards."""

    def __enter__(self):
        from clustertracking_tpu_torch import refine
        from clustertracking_tpu_torch.ops.pixel_lm import pixel_lm

        self.first = {}
        self.orig = refine.pixel_lm

        def wrapped(*args, **kw):
            before = pixel_lm.launches_resident
            res = self.orig(*args, **kw)
            mode = ("resident" if pixel_lm.launches_resident > before
                    else "streamed")
            self.first.setdefault(mode, (args, kw))
            return res

        refine.pixel_lm = wrapped
        return self

    def __exit__(self, *exc):
        from clustertracking_tpu_torch import refine

        refine.pixel_lm = self.orig


class _ShardLaunches:
    """Counts the kernels' launches per shard while a sharded main path
    runs.  It wraps ``refine.split_lanes``, which makes every dispatch's
    shards, and keeps each shard's frame_idx and params0 blocks; a
    ``fused_lm_2d`` or ``pixel_lm`` launch belongs to the shard whose
    params0 block it gets, a ``window_gather`` launch (through the
    wrapper's ``_launch``) to the shard whose frame_idx block it gets.
    ``shards`` holds one count dict per shard of every dispatch."""

    KINDS = ("fused_lm_2d", "window_gather", "pixel_lm")

    def __enter__(self):
        from clustertracking_tpu_torch import refine
        from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d
        from clustertracking_tpu_torch.ops.pixel_lm import pixel_lm

        wg = _window_gather_module()
        self.blocks, self.shards = [], []
        self.orig = (refine.split_lanes, refine.fused_lm_2d,
                     refine.pixel_lm, wg._launch)
        split, fused, pixel, launch = self.orig

        def owner(t, i):
            for (fidx, params0), n in zip(self.blocks, self.shards):
                if t is (fidx, params0)[i]:
                    return n
            return {}

        def add(kind, t, i, n):
            d = owner(t, i)
            if d:
                d[kind] += n

        def split_w(*args, **kw):
            out = split(*args, **kw)
            for a in out:   # (frames, frame_idx, params0, ...)
                self.blocks.append((a[1], a[2]))
                self.shards.append(dict.fromkeys(self.KINDS, 0))
            return out

        def fused_w(*args, **kw):
            before = fused_lm_2d.launches
            res = fused(*args, **kw)
            add("fused_lm_2d", args[1], 1, fused_lm_2d.launches - before)
            return res

        def pixel_w(*args, **kw):
            before = pixel_lm.launches_resident + pixel_lm.launches_streamed
            res = pixel(*args, **kw)
            add("pixel_lm", args[1], 1, pixel_lm.launches_resident
                + pixel_lm.launches_streamed - before)
            return res

        def launch_w(frames, frame_idx, *rest):
            rc = launch(frames, frame_idx, *rest)
            add("window_gather", frame_idx, 0, int(rc == 0))
            return rc

        refine.split_lanes, refine.fused_lm_2d = split_w, fused_w
        refine.pixel_lm, wg._launch = pixel_w, launch_w
        return self

    def __exit__(self, *exc):
        from clustertracking_tpu_torch import refine

        (refine.split_lanes, refine.fused_lm_2d, refine.pixel_lm,
         _window_gather_module()._launch) = self.orig

    def least(self, kind):
        """The fewest launches of ``kind`` on any shard of any dispatch
        (0 where no dispatch was split)."""
        return min((n[kind] for n in self.shards), default=0)


def _pixel_replay(first, mode, what, smi):
    """pixel_lm in ``mode`` vs its plain version on a main path's first
    launch in that mode (``_FirstPixel``): agreement, ms, bound.  Returns
    the kernels-line entry without its launches."""
    import torch

    check(mode in first.first, f"{what}: no {mode} pixel_lm launch to "
          "replay")
    args, kw = first.first[mode]
    kw = {k: v for k, v in kw.items() if k != "streaming"}
    layout = kw["layout"]
    pos = sorted({int(s) for p in layout.pos_param_idx
                  for s in layout.slot_idx[:, p]})
    call, plain = _launcher(mode), _plain(mode)
    res_p, plain_ms = _timed(lambda: plain(args, kw))
    res_k = call(args, kw)
    torch.cuda.synchronize()
    a = _agreement(res_k, res_p, pos)
    bound = _lm_bound(res_k, args, kw)
    ms = _cuda_ms(lambda: call(args, kw), 5)
    print(f"[{what}] {smi}: pixel_lm {mode} vs plain on the first shard's "
          f"first launch (B={len(args[0])}, window {kw['window_shape']}): "
          f"{_fmt(a)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; time over bound "
          f"{ms / bound['bound_ms']:.1f}x)", flush=True)
    return dict(max_abs_err=a["pos"], ms=ms, plain_ms=plain_ms, **bound,
                library_ms=None)


def _walled(fn):
    """(result, seconds) of ``fn`` with the card synchronized around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_mesh(c1, c4, frames, truth, raw, c5_truth, device, smi):
    """The multi-device path over MESH_SHARDS shards on the visible cards
    in turn: config 1 and config 4 through refine_leastsq(mesh=), and
    config 4's bucket through sharded_fit, against one device (bit for
    bit); a tie across the shards on config 2's video ('global' size and
    dimer_global()); sharded linking of configs 2 and 5; track(mesh=) on
    config 2.  Returns the kernels-line entries of the kernels the sharded
    path launches (fused_lm_2d, window_gather, pixel_lm in both modes),
    their launches counted over the phase's sharded runs."""
    import torch

    from clustertracking_tpu_torch import (
        diagnostics, dimer_global, find_clusters, link, refine_leastsq,
        track)
    from clustertracking_tpu_torch.entry import (
        MODES_3D, RADIUS_3D, WINDOW_3D, entry_3d)
    from clustertracking_tpu_torch.parallel.linking import link_sharded
    from clustertracking_tpu_torch.parallel.sharding import (
        make_mesh, sharded_fit)

    t_phase = time.perf_counter()
    mesh = _mesh()
    print(f"[mesh] {smi}: {mesh.size} shards on {len(mesh.distinct)} "
          f"distinct card(s) {[str(d) for d in mesh.distinct]}", flush=True)
    counts = {}

    def sharded(fn, *wrappers):
        """A sharded main-path run, its launches tallied."""
        _reset_counts()
        with diagnostics.collect() as stats:
            out, wall = _walled(fn)
        _tally(counts)
        tags = {b.backend for b in stats.batches}
        check(tags and all(t.endswith("-sharded") for t in tags),
              f"untagged sharded dispatches {tags}")
        return out, wall, stats

    # (a) config 1 through refine_leastsq, four shards against one device
    f1, frames1, out1 = c1
    kw1 = dict(diameter=9, separation=6.0)
    single, wall_1 = _walled(lambda: refine_leastsq(f1, frames1,
                                                    device=device, **kw1))
    with _FirstLaunch(rigid=False) as first_fused, \
            _ShardLaunches() as per_a:
        out_m, wall_m, stats = sharded(
            lambda: refine_leastsq(f1, frames1, mesh=mesh, **kw1))
    tags = sorted({b.backend for b in stats.batches})
    n_fused = first_fused.launches[False]
    per_shard = [n["fused_lm_2d"] for n in per_a.shards]
    print(f"[mesh] {smi}: (a) config 1, refine_leastsq on {len(f1)} rows: "
          f"{wall_m:.3f} s sharded, {wall_1:.3f} s on one device "
          f"({wall_m / wall_1:.2f}x), {len(stats.batches)} dispatches {tags},"
          f" {n_fused} fused_lm_2d launches, by shard of each dispatch "
          f"{per_shard}; every lane bit-equal to [refine]"
          f" and to the one-device run: "
          f"{_bit_equal(out_m, out1, MESH_COLS)}, "
          f"{_bit_equal(out_m, single, MESH_COLS)}", flush=True)
    check(_bit_equal(out_m, out1, MESH_COLS)
          and _bit_equal(out_m, single, MESH_COLS),
          "config 1 sharded differs from one device")
    check(tags == ["cuda-fused-sharded"], f"config 1 sharded took {tags}")
    check(len(per_shard) == mesh.size * len(stats.batches)
          and per_a.least("fused_lm_2d") >= 1,
          f"a shard launched no fused_lm_2d: {per_shard}")

    # (b) config 4: refine_leastsq on [refine3d]'s scene (its 7x9x9
    # diameter: occupancy picks pixel_lm streamed), then sharded_fit with
    # entry_3d's bucket (9x13x13 windows: resident), window_gather then
    # pixel_lm on every shard
    batch4, f4, out4 = c4
    kw4 = dict(diameter=(7, 9, 9), separation=5.0, param_mode={
        "size_z": "var", "size_y": "var", "size_x": "var"})
    single4, wall_4 = _walled(lambda: refine_leastsq(f4, batch4[0],
                                                     device=device, **kw4))
    solve, args = entry_3d(device, batch=batch4)
    one_fit, wall_f1 = _walled(lambda: solve(*args))
    fit, _ = sharded_fit(mesh, "gauss", 3, False, 2, WINDOW_3D, RADIUS_3D,
                         param_mode=dict(MODES_3D))
    before = dict(counts)
    with _FirstPixel() as first_pixel:
        with _ShardLaunches() as per_4:
            out_m4, wall_m4, stats4 = sharded(
                lambda: refine_leastsq(f4, batch4[0], mesh=mesh, **kw4))
        n4 = {k: counts[k] - before.get(k, 0) for k in counts}
        _reset_counts()
        with _ShardLaunches() as per_f:
            m_fit, wall_fm = _walled(lambda: fit(*args))
        nf = _counts()
        _tally(counts)
    tags4 = sorted({b.backend for b in stats4.batches})
    cols4 = ("z", "y", "x", "signal", "size_z", "size_y", "size_x", "cost",
             "fit_converged", "fit_n_iter")
    fit_equal = all(torch.equal(u.to(v.device), v)
                    for u, v in zip(m_fit[:4], one_fit[:4]))
    print(f"[mesh] {smi}: (b) config 4, refine_leastsq on {len(f4)} rows: "
          f"{wall_m4:.3f} s sharded, {wall_4:.3f} s on one device "
          f"({wall_m4 / wall_4:.2f}x), {tags4}, launches {n4} (by shard of "
          f"each dispatch {per_4.shards}); every lane "
          f"bit-equal to [refine3d] and to the one-device run: "
          f"{_bit_equal(out_m4, out4, cols4)}, "
          f"{_bit_equal(out_m4, single4, cols4)}; sharded_fit with "
          f"entry_3d's bucket (B={len(batch4[1])}, {WINDOW_3D}): "
          f"{wall_fm * 1e3:.2f} ms sharded, {wall_f1 * 1e3:.2f} ms on one "
          f"device, launches {nf} (by shard {per_f.shards}), params, rms, "
          f"converged and n_iter "
          f"bit-equal: {fit_equal}", flush=True)
    check(_bit_equal(out_m4, out4, cols4)
          and _bit_equal(out_m4, single4, cols4),
          "config 4 sharded differs from one device")
    check(fit_equal, "sharded_fit differs from entry_3d's solver")
    check(tags4 == ["cuda-gathered-sharded"], f"config 4 sharded took {tags4}")
    for per in (per_4, per_f):
        check(len(per.shards) >= mesh.size
              and per.least("window_gather") >= 1
              and per.least("pixel_lm") >= 1,
              f"a config 4 shard launched no window_gather or pixel_lm: "
              f"{per.shards}")
    check(set(first_pixel.first) == {"resident", "streamed"},
          f"config 4's sharded runs took pixel_lm {sorted(first_pixel.first)}")

    # (c) the tie across the shards: config 2's video in one dispatch, the
    # size 'global' and one bond length for the video.  One refit round:
    # each bucket's tie is then one joint solve over every lane (a later
    # round re-ties only the lanes that moved, in both packages)
    fc = find_clusters(raw.copy(), LOC_SEPARATION)
    kwc = dict(diameter=LOC_DIAMETER, separation=LOC_SEPARATION,
               constraints=dimer_global(ndim=2), param_val={"size": LOC_SIZE},
               param_mode={"size": "global"}, frames_per_dispatch=LOC_FRAMES,
               max_iter=1)
    tie_1, wall_t1 = _walled(lambda: refine_leastsq(fc, frames, device=device,
                                                    **kwc))
    with _FirstGather() as first_gather, _ShardLaunches() as per_t:
        tie_m, wall_tm, stats_t = sharded(
            lambda: refine_leastsq(fc, frames, mesh=mesh, **kwc))
    tie_m2, _, _ = sharded(lambda: refine_leastsq(fc, frames, mesh=mesh,
                                                  **kwc))
    same_run = _bit_equal(tie_m, tie_m2, list(tie_m.columns)) and \
        tie_m.attrs == tie_m2.attrs
    spread, rel = {}, {}
    for n, g in tie_m[tie_m["cost"].notna()].groupby("cluster_size"):
        g1 = tie_1[(tie_1["cluster_size"] == n) & tie_1["cost"].notna()]
        spread[int(n)] = float(np.ptp(g["size"].to_numpy()))
        rel[int(n)] = float(abs(g["size"].mean() / g1["size"].mean() - 1))
    d_m, d_1 = tie_m.attrs["global_dist"], tie_1.attrs["global_dist"]
    rel_d = abs(d_m / d_1 - 1)
    tags_t = sorted({b.backend for b in stats_t.batches})
    print(f"[mesh] {smi}: (c) the tie, config 2's {LOC_FRAMES} frames in one "
          f"dispatch ({len(fc)} candidates): {wall_tm:.3f} s sharded, "
          f"{wall_t1:.3f} s on one device ({wall_tm / wall_t1:.2f}x), "
          f"{tags_t}; tied size's spread by cluster size {spread} (tol "
          f"{MESH_PTP:g}), relative to one device {rel}; global_dist "
          f"{d_m:.6f} px sharded, {d_1:.6f} on one device (rel {rel_d:.2e}, "
          f"tol {MESH_TIE_RTOL:g}); two sharded runs bit-equal: {same_run};"
          f" window_gather by shard of each dispatch "
          f"{[n['window_gather'] for n in per_t.shards]}", flush=True)
    check(spread and max(spread.values()) < MESH_PTP,
          f"the tied size spreads {spread}")
    check(max(rel.values()) < MESH_TIE_RTOL, f"tied size vs one device {rel}")
    check(rel_d < MESH_TIE_RTOL, f"global_dist vs one device {rel_d}")
    check(same_run, "two sharded runs of the tie differ")
    check("cuda-torch-rigid-global-sharded" in tags_t,
          f"the tie took {tags_t}")
    check(len(per_t.shards) >= mesh.size
          and per_t.least("window_gather") >= 1,
          f"a shard of the tie launched no window_gather: {per_t.shards}")

    # (d) sharded linking of the truth rows
    cpu_mesh = make_mesh(["cpu"] * MESH_SHARDS)
    for name, tr, memory, backend in (("config 2", truth, 6, "device"),
                                      ("config 5", c5_truth, 2,
                                       "device-binned")):
        fl = tr[["frame", "y", "x"]].reset_index(drop=True)
        one, one_s = _walled(lambda: link(fl, 3.0, memory=memory,
                                          backend=backend, device=device))
        card, card_s = _walled(lambda: link(fl, 3.0, memory=memory,
                                            mesh=mesh))
        st = dict(link_sharded.last_stats)
        cpu = link(fl, 3.0, memory=memory, mesh=cpu_mesh)
        check(card.attrs["link_backend"] == f"sharded:{backend}",
              f"{name}: sharded link took {card.attrs['link_backend']}")
        check(np.array_equal(card["particle"].to_numpy(),
                             cpu["particle"].to_numpy()),
              f"{name}: sharded link on the card and on the CPU differ")
        p1, pm = one["particle"].to_numpy(), card["particle"].to_numpy()
        same = _rows_in_identical_trajectories(pm, p1)
        T = int(fl["frame"].nunique())
        print(f"[mesh] {smi}: (d) {name} truth, {T} frames x "
              f"{len(fl) // T} features, memory {memory}: link(mesh=) "
              f"{card_s * 1e3:.2f} ms ({st['shards']} shards of "
              f"{-(-T // st['shards'])} frames; auctions "
              f"{st['link_s'] * 1e3:.2f} ms, stitch {st['stitch_s'] * 1e3:.2f}"
              f" ms), single scan {one_s * 1e3:.2f} ms; equal to the CPU's "
              f"particle for particle; {same} of {len(fl)} rows in "
              f"trajectories identical to the single scan's; trajectories "
              f"{len(np.unique(pm))} sharded, {len(np.unique(p1))} single",
              flush=True)
        if backend == "device":
            check(np.array_equal(_partition(pm), _partition(p1)),
                  f"{name}: sharded trajectories differ from the single "
                  "scan's")
        else:
            check(same >= LINK_AGREE * len(fl),
                  f"{name}: {len(fl) - same} rows in trajectories that "
                  "differ from the single scan's")

    # (e) track(mesh=) on config 2 against one device, both warm
    reader = _Stack(frames)
    track(reader, mesh=mesh, **TRACK_KW)      # untimed: first-use costs
    with diagnostics.collect() as st1:
        tr1, w1 = _walled(lambda: track(reader, device=device, **TRACK_KW))
    trm, wm, stm = sharded(lambda: track(reader, mesh=mesh, **TRACK_KW))
    err, recall, _ = _track_accuracy(trm, truth)
    T = len(frames)
    same_rows = _bit_equal(trm, tr1, ("frame", "y", "x", "signal", "cost"))
    same_traj = _rows_in_identical_trajectories(
        trm["particle"].to_numpy(), tr1["particle"].to_numpy())
    # the stitch is the reference's, not the single scan: at a cut it
    # pairs only tracks that end before it with tracks that start after
    # it, so fitted rows with gaps can pair otherwise than the single scan
    # (tests/test_torch_parallel_link.py::
    # test_link_mesh_rows_with_gaps_pair_as_the_reference holds both
    # packages' link(mesh=) equal on such rows, and unequal to the single
    # scan; scripts/sharded_link_parity.py does so on these very rows);
    # here the card's sharded link is held to the CPU's on the same rows
    cpu = link(trm[["frame", "y", "x"]], TRACK_KW["search_range"],
               memory=TRACK_KW["memory"], mesh=cpu_mesh)
    cpu_same = np.array_equal(cpu["particle"].to_numpy(),
                              trm["particle"].to_numpy())
    print(f"[mesh] {smi}: (e) track(mesh=) on config 2: {T / wm:.2f} "
          f"frames/s ({wm:.3f} s), one device {T / w1:.2f} frames/s "
          f"({w1:.3f} s); ledger sharded: {_ledger(stm)}; one device: "
          f"{_ledger(st1)}; {len(trm)} rows bit-equal to one device's: "
          f"{same_rows}, {same_traj} of them in trajectories identical to "
          f"one device's ({trm['particle'].nunique()} trajectories sharded, "
          f"{tr1['particle'].nunique()} on one device; the sharded link "
          f"equal to the CPU's on the same rows: {cpu_same}); median |pos - "
          f"truth| {err:.4f} px, recall within 1 px {recall:.4f}",
          flush=True)
    check(trm.attrs["link_backend"] == "sharded:device",
          f"track(mesh=) linked with {trm.attrs['link_backend']}")
    check(same_rows, "track(mesh=)'s rows differ from one device's")
    check(cpu_same, "track(mesh=)'s sharded link differs from the CPU's")
    check(err < TRACK_ERR, f"track(mesh=) median position error {err} px")
    check(recall >= TRACK_RECALL, f"track(mesh=) recall {recall}")

    # (f) each kernel of the sharded path against its plain version, on
    # its first shard launch
    check(all(counts[k] > 0 for k in ("fused_lm_2d", "window_gather",
                                      "resident", "streamed")),
          f"a kernel of the sharded path was not launched: {counts}")
    print(f"[mesh] {smi}: launches over the phase's sharded runs {counts}",
          flush=True)
    entries = dict(
        fused=dict(launches=counts["fused_lm_2d"],
                   **_replay(first_fused, "mesh", smi)),
        gather=dict(launches=counts["window_gather"],
                    **_gather_replay(first_gather, "mesh", smi)),
        **{mode: dict(launches=counts[mode],
                      **_pixel_replay(first_pixel, mode, "mesh", smi))
           for mode in ("resident", "streamed")})
    print(f"[mesh] {smi}: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


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
    phase_profile(batch, device, smi)
    _stamp("profile")
    c1 = phase_refine(batch, device, smi)
    _stamp("refine")
    del batch
    batch3d = example_batch_3d(B=B_3D, with_truth=True)
    big = example_batch_3d(B=B_3D_BIG)
    k3 = phase_kernel3d(batch3d, big, device, smi)
    _stamp("kernel3d")
    n3 = phase_main3d(batch3d, device, smi)
    _stamp("main3d")
    solve_big, args_big = phase_rates3d(batch3d, big, device, smi)
    _stamp("rates3d")
    phase_profile3d(solve_big, args_big, smi)
    _stamp("profile3d")
    del solve_big, args_big, big
    torch.cuda.empty_cache()
    phase_stream2d(device, smi)
    _stamp("stream2d")
    c4 = phase_refine3d(batch3d, device, smi)
    _stamp("refine3d")
    del batch3d
    kp, np_ = phase_profiles(device, smi)
    _stamp("profiles")
    rigid = {c: example_batch_rigid(c, with_truth=True) for c in RIGID_CONFIGS}
    kr = phase_kernel_rigid(rigid, device, smi)
    _stamp("kernel_rigid")
    nr = phase_rigid(rigid, device, smi)
    _stamp("rigid")
    phase_refine_rigid(rigid, device, smi)
    _stamp("refine_rigid")
    del rigid
    frames, truth, raw = phase_locate(device, smi)
    _stamp("locate")
    kt, gt = phase_train(device, smi)
    _stamp("train")
    kg, gg = phase_global(frames, truth, raw, device, smi)
    _stamp("global")
    from clustertracking_tpu_torch.pipeline import _locate_frames

    c5_frames, c5_truth = _video(C5_FRAMES, C5_SHAPE, C5_DIMERS,
                                 seed=C5_SEED)
    c5_cands = _locate_frames(
        _Stack(c5_frames[:1]), range(1), (LOC_DIAMETER,) * 2,
        (LOC_SEPARATION // 2,) * 2, None, 64.0,
        TRACK5_KW["max_features"], "frame", device=device)
    _stamp("config 5 scene")
    phase_find(c5_cands[["y", "x"]].to_numpy(dtype=float), device, smi)
    _stamp("find")
    phase_link(truth, c5_truth, device, smi)
    _stamp("link")
    ktr = phase_track(frames, truth, device, smi)
    _stamp("track")
    ktr5, gtr5 = phase_track5(c5_frames, c5_truth, device, smi)
    _stamp("track5")
    phase_synth(c5_truth, device, smi)
    _stamp("synth")
    ktr_r = phase_track_r(frames, truth, device, smi)
    _stamp("track_r")
    ktr5r, gtr5r = phase_track5r(c5_frames, c5_truth, device, smi)
    _stamp("track5r")
    phase_trace(frames, device, smi)
    _stamp("trace")
    km = phase_mesh(c1, c4, frames, truth, raw, c5_truth, device, smi)
    _stamp("mesh")
    del c1, c4, raw
    # window_gather and pixel_lm's two modes keep config 4's own counts
    # (main3d: three solves), the shape their entries are timed at; the
    # calibration path's gathers have entries of their own below
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
    # the calibration workflow: inv_series_2 in the refit with the learned
    # coefficients, the n-gon pose in dimer_global's fixed-distance refit
    kernels.append(dict(name="fused_lm_2d [inv_series_2, train]",
                        route="cuda", source=src + "fused_lm_2d.cu",
                        replaces=lm + "1213", **kt))
    kernels.append(dict(name="fused_lm_2d [rigid n-gon, global]",
                        route="cuda", source=src + "fused_lm_2d.cu",
                        replaces=lm + "570", **kg))
    # the gather of the calibration path: the global buckets' solves and
    # the pooled normal equations (train._global_eq, refine._dist_eq)
    for what, entry in (("train", gt), ("global", gg)):
        kernels.append(dict(
            name=f"window_gather [{what}]", route="cuda",
            source=src + "window_gather.cu",
            replaces="clustertracking_tpu/ops/pallas_gather.py:144",
            **entry))
    # the tracking pipeline: config 2's fits, and config 5's small clusters
    # in fused_lm_2d and its chains' windows in window_gather
    for what, entry in (("track, config 2", ktr), ("track5, config 5", ktr5)):
        kernels.append(dict(name=f"fused_lm_2d [{what}]", route="cuda",
                            source=src + "fused_lm_2d.cu",
                            replaces=lm + "1213", **entry))
    kernels.append(dict(
        name="window_gather [track5, config 5]", route="cuda",
        source=src + "window_gather.cu",
        replaces="clustertracking_tpu/ops/pallas_gather.py:144", **gtr5))
    # the recovery passes: the joint refit's first launches (configs 2 and
    # 5 with recover_passes=1), counted over the whole track call
    for what, entry in (("track_r, config 2 recovery refit", ktr_r),
                        ("track5r, config 5 recovery refit", ktr5r)):
        kernels.append(dict(name=f"fused_lm_2d [{what}]", route="cuda",
                            source=src + "fused_lm_2d.cu",
                            replaces=lm + "1213", **entry))
    kernels.append(dict(
        name="window_gather [track5r, config 5 recovery refit]",
        route="cuda", source=src + "window_gather.cu",
        replaces="clustertracking_tpu/ops/pallas_gather.py:144", **gtr5r))
    # the mesh: the first shard's launch of each kernel the sharded path
    # runs, launches counted over the phase's sharded runs
    for name, route, file, line in (
            ("fused_lm_2d [mesh, config 1 shard]", "fused",
             "fused_lm_2d.cu", lm + "1213"),
            ("window_gather [mesh, tie]", "gather", "window_gather.cu",
             "clustertracking_tpu/ops/pallas_gather.py:144"),
            ("pixel_lm (resident) [mesh, config 4 shard]", "resident",
             "pixel_lm.cu", lm + "1143"),
            ("pixel_lm (streamed) [mesh, config 4 refine3d shard]",
             "streamed", "pixel_lm.cu", lm + "1161")):
        kernels.append(dict(name=name, route="cuda", source=src + file,
                            replaces=line, **km[route]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def _ptxas_entries(report):
    """(kernel, registers, bytes of spill stores and loads) of each entry
    in nvcc's -Xptxas -v report."""
    out, entry, spill = [], None, 0
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], 0
        elif "spill stores" in line and entry is not None:
            spill = sum(int(n) for n in re.findall(
                r"(\d+) bytes spill", line))
        elif "registers" in line and entry is not None:
            out.append((entry, int(line.split("Used")[1].split()[0]), spill))
            entry = None
    return out


def _template_args(entry):
    """The integer template arguments of a mangled kernel name."""
    return re.findall(r"L[ib](\d+)", entry.split("_kernel", 1)[1]
                      .split("EEEv")[0])


def _warps_by_registers(regs, warps_per_block=1):
    """Warps per SM that a kernel's registers allow.  Each of an SM's four
    partitions has 16,384 registers, handed out per warp in units of 256;
    a block's warps share a partition only when it has one warp, as the LM
    kernels' blocks do (at most 32 blocks per SM)."""
    per_warp = 32 * (-(-regs // 8) * 8)
    if warps_per_block == 1:
        return min(32, 4 * (16384 // per_warp))
    return min(64, 65536 // per_warp)


def gauss_kernels(root, save=None):
    """The gauss LM kernels of the port found under ``root`` (this
    checkout, or another one such as the parent commit's), timed on one
    card at the first-round inputs of four cells: fused_lm_2d at config 1
    (B=16,384) and, rigid, at config 3's dimers (B=4,096); pixel_lm
    resident and streamed at config 4 and, rigid, at config 3c (B=2,048
    each).  Each is held against its plain version and printed with its
    registers and pixel_lm's occupancy; ``save`` keeps every kernel's
    per-lane x, cost, n_iter and npix in an .npz file.  One line per cell;
    run two checkouts in turns to compare them."""
    import inspect

    sys.path.insert(0, root)
    import torch

    from clustertracking_tpu_torch.entry import (
        WINDOW_3D, example_batch, example_batch_3d, example_batch_rigid)
    from clustertracking_tpu_torch.models import get_model
    from clustertracking_tpu_torch.ops import _build
    from clustertracking_tpu_torch.ops.pixel_lm import occupancy

    check(torch.cuda.is_available(), "no CUDA device")
    device = "cuda"
    t0 = time.perf_counter()
    _build.build_kernels(("fused_lm_2d", "pixel_lm"))
    build_s = time.perf_counter() - t0
    # the gauss instantiations, by their template arguments (profile 0):
    # fused_lm_2d (profile, pose[, ceiling]), pixel_lm (D, streamed,
    # profile, pose[, ceiling])
    regs, spills = {}, {}
    for n, prof_at in (("fused_lm_2d", 0), ("pixel_lm", 2)):
        for entry, r, b in _ptxas_entries(_build.build_log(n)[1]):
            targs = _template_args(entry)
            if targs[prof_at] == "0":
                regs[f"{n}<{','.join(targs)}>"] = r
            if b:
                spills[f"{n}<{','.join(targs)}>"] = b
    kept = {}

    def device_ms(call, args, kw, reps=5):
        """The LM kernel's own time per launch (torch.profiler), without
        the wrapper's host work."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call(args, kw)
            torch.cuda.synchronize()
        return sum(v for k, v in _device_ms(prof).items()
                   if "lm_2d_kernel" in k or "pixel_lm_kernel" in k) / reps

    def cell(name, route, args, kw, pos, reps):
        call, plain = _launcher(route), _plain(route)
        res = call(args, kw)
        torch.cuda.synchronize()
        a = _agreement(res, plain(args, kw), pos)
        ms = _cuda_ms(lambda: call(args, kw), reps)
        dev = device_ms(call, args, kw)
        bound = _lm_bound(res, args, kw)["bound_ms"]
        for f in ("x", "cost", "n_iter", "npix"):
            kept[f"{name}/{route}/{f}"] = getattr(res, f).cpu().numpy()
        return (f"{route} {ms:.4f} ms per call, kernel alone {dev:.4f} ms "
                f"({dev / bound:.1f}x its bound; max "
                f"|dpos| {a['pos']:.3e}, cost rel above floor "
                f"{a['cost_rel_above_floor']:.3e}, converged equal "
                f"{a['conv']:.5f}, n_iter equal {a['iters']:.5f}, mean "
                f"n_iter {float(res.n_iter.float().mean()):.2f}, mean npix "
                f"{float(res.npix.mean()):.2f})")

    lines = []
    args, kw, layout = _first_round_inputs(
        example_batch(B=B_FULL, frame_size=FRAME, grid_pitch=PITCH), device)
    pos = sorted({int(s) for p in layout.pos_param_idx
                  for s in layout.slot_idx[:, p]})
    lines.append(f"config 1 B={B_FULL}: "
                 + cell("config1", "fused", args, kw, pos, 20))
    _, args, kw, layout = _first_round_inputs_3d(
        example_batch_3d(B=B_3D), device)
    pos = sorted({int(s) for p in layout.pos_param_idx
                  for s in layout.slot_idx[:, p]})
    lines.append(f"config 4 B={B_3D}: " + "; ".join(
        cell("config4", r, args, kw, pos, 20)
        for r in ("resident", "streamed")))
    for config, routes in (("3-dimer", ("fused",)),
                           ("3c", ("resident", "streamed"))):
        c, layout = _rigid_layout(config)
        args, kw = _round_inputs(
            get_model("gauss"), layout, example_batch_rigid(config),
            c["window"], c["radius"], device, c["ndim"] == 3, c["con"])
        posf = _rigid_positions(layout, c["con"])
        lines.append(f"config {config} B={len(args[0])}: " + "; ".join(
            cell(config, r, args, kw, posf, 10) for r in routes))
    occ = {}
    for name, V in (("config 4", 14), ("config 3c", 10)):
        extra = ({"n_slots": V} if "n_slots" in inspect.signature(
            occupancy).parameters else {})
        window = WINDOW_3D if name == "config 4" else (16, 16, 16)
        pose = 0 if name == "config 4" else 3
        occ[name] = occupancy(window, pose=pose, **extra)
    for line in lines:
        print(f"[gauss_kernels] {root}: {line}", flush=True)
    print(f"[gauss_kernels] {root}: build {build_s:.1f} s; pixel_lm "
          f"occupancy {occ} warps/SM; registers {regs}; spilled bytes: "
          f"{spills or 'none'}", flush=True)
    if save:
        np.savez(save, **kept)


def gather_kernels(root):
    """The window gather of the port found under ``root`` (this checkout,
    or another one such as the parent commit's), timed on one card at
    config 4's first-round inputs, B=2,048 and B=16,384: kernel alone with
    L2 flushed before each call, per call and host µs per call, held
    bit-equal to gather_stack, beside gather_stack and the bytes bound.
    One line per size; run two checkouts in turns to compare them."""
    sys.path.insert(0, root)
    import torch

    from clustertracking_tpu_torch.entry import WINDOW_3D, example_batch_3d
    from clustertracking_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "no CUDA device")
    t0 = time.perf_counter()
    _build.build_kernels(("window_gather",))
    build_s = time.perf_counter() - t0
    for B in (B_3D, B_3D_BIG):
        st, args, _, _ = _first_round_inputs_3d(example_batch_3d(B=B),
                                                "cuda")
        g = _gather_cell(st.frames, st.frame_idx, args[4], WINDOW_3D,
                         GATHER_REPS)
        bound_ms = _bound(g["bytes"], 0)["bound_ms"]
        print(f"[gather_kernels] {root}: B={B}, {WINDOW_3D}: " + "; ".join(
            _fmt_gather(v, g[v], bound_ms) for v in ("kernel", "plain"))
            + f"; bound {bound_ms:.4f} ms (bytes)", flush=True)
        del st, args, g
        torch.cuda.empty_cache()
    regs = {e: r for e, r, _ in _ptxas_entries(
        _build.build_log("window_gather")[1])}
    print(f"[gather_kernels] {root}: build {build_s:.1f} s; registers "
          f"{regs}", flush=True)


def compare_saved(file_a, file_b):
    """Share of lanes on which two ``--save`` files agree bit for bit, per
    kernel: x, cost and n_iter together, and npix."""
    a, b = np.load(file_a), np.load(file_b)
    for key in sorted(k[:-2] for k in a.files if k.endswith("/x")):
        xa, xb = a[key + "/x"], b[key + "/x"]
        same = ((xa.view(np.int32) == xb.view(np.int32)).all(axis=1)
                & (a[key + "/cost"].view(np.int32)
                   == b[key + "/cost"].view(np.int32))
                & (a[key + "/n_iter"] == b[key + "/n_iter"]))
        npix = a[key + "/npix"] == b[key + "/npix"]
        print(f"[compare_saved] {key}: x, cost and n_iter bit-equal on "
              f"{same.mean():.5f} of {len(same)} lanes; n_iter equal on "
              f"{(a[key + '/n_iter'] == b[key + '/n_iter']).mean():.5f}; "
              f"npix equal on {npix.mean():.5f}; max |dx| "
              f"{np.nanmax(np.abs(xa - xb)):.3e}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gauss-kernels"]:
        rest = sys.argv[2:]
        save = rest[rest.index("--save") + 1] if "--save" in rest else None
        gauss_kernels(rest[0] if rest and rest[0] != "--save" else ".", save)
    elif sys.argv[1:2] == ["--gather-kernels"]:
        gather_kernels(sys.argv[2] if len(sys.argv) > 2 else ".")
    elif sys.argv[1:2] == ["--compare-saved"]:
        compare_saved(sys.argv[2], sys.argv[3])
    else:
        main()
