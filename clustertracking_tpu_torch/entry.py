"""Entry points of the main path: the bucketed cluster fit.

``entry(device)`` is the counterpart of ``__graft_entry__.entry()``: it
returns the bucket solver for 2D Gaussian dimers in 13×13 windows
(radius 4.5, refit-on-shift up to 10 rounds, up to 60 LM iterations) with
example arguments on ``device``.  ``example_batch`` is a numpy copy of
``__graft_entry__._example_batch`` and gives identical arrays.

``entry_3d(device)`` is the same for config 4 of
``benchmarks/suite.py``: anisotropic 3D Gaussian dimers in z-stacks,
9×13×13 windows, radius (3.0, 4.5, 4.5), every size fitted per feature
(V = 14); ``example_batch_3d`` draws its scene as the suite does.

``entry_rigid(config, device)`` is the same for the rigid cells: config
3's 2D dimers and trimers, config 3b's 3D dimers and config 3c's 3D
tetramers (``RIGID_CONFIGS``); ``example_batch_rigid`` draws them.

``dryrun_multichip(n_devices, device=None)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: the public API over an
``n_devices``-shard mesh.
"""
from __future__ import annotations

import numpy as np

from . import artificial
from .constraints import dimer, positions_to_pose, tetramer, trimer
from .interop import from_reference
from .models.registry import get_model
from .refine import _bucket_solver

__all__ = ["example_batch", "example_batch_3d", "example_batch_rigid",
           "entry", "entry_3d", "entry_rigid", "WINDOW", "RADIUS",
           "WINDOW_3D", "RADIUS_3D", "MODES_3D", "RIGID_CONFIGS",
           "dryrun_multichip"]

WINDOW = (13, 13)
RADIUS = (4.5, 4.5)
WINDOW_3D = (9, 13, 13)
RADIUS_3D = (3.0, 4.5, 4.5)
MODES_3D = (("size_x", "var"), ("size_y", "var"), ("size_z", "var"))


def example_batch(B=64, T=None, frame_size=64, seed=0, grid_pitch=16,
                  with_truth=False):
    """Synthetic dimer batch on a non-overlapping grid: each dimer owns a
    grid_pitch² cell so neighboring clusters never leak into a window.
    Returns (frames [T,H,W], frame_idx, params0, pose0, valid), plus the
    true positions [B, 2, 2] when ``with_truth``."""
    rng = np.random.default_rng(seed)
    n, P = 2, 5  # dimer, gauss iso 2D: [bg, signal, y, x, size]
    per_axis = frame_size // grid_pitch
    per_frame = per_axis * per_axis
    if T is None:
        T = max(1, -(-B // per_frame))  # ceil
    frames = np.zeros((T, frame_size, frame_size), dtype=np.float32)
    params0 = np.zeros((B, n, P), dtype=np.float32)
    truth = np.zeros((B, n, 2))
    fidx = np.zeros(B, dtype=np.int32)
    for b in range(B):
        t = (b // per_frame) % T
        cell = b % per_frame
        cy = (cell // per_axis) * grid_pitch + grid_pitch / 2
        cx = (cell % per_axis) * grid_pitch + grid_pitch / 2
        center = np.array([cy, cx]) + rng.uniform(-1.5, 1.5, 2)
        true = artificial.draw_cluster(
            frames[t], center, size=2.5, separation=5.0, n=2,
            signal=150.0, angle=rng.uniform(0, np.pi),
        )
        truth[b] = true
        params0[b, :, 1] = 150.0
        params0[b, :, 2:4] = true + rng.uniform(-0.3, 0.3, true.shape)
        params0[b, :, 4] = 2.5
        fidx[b] = t
    pose0 = np.zeros((B, 0), dtype=np.float32)
    valid = np.ones(B, dtype=bool)
    out = (frames, fidx, params0, pose0, valid)
    return out + (truth,) if with_truth else out


def entry(device, batch=None, **batch_kwargs):
    """(solve, example_args): the main-path bucket solver and an example
    batch as tensors on ``device`` — ``batch`` (the five arrays of
    ``example_batch``) or ``example_batch(**batch_kwargs)``.

    ``solve(*example_args)`` returns (params, rms, converged, iters, std).
    """
    solver, _ = _bucket_solver(
        get_model("gauss"), 2, True, 2, (), WINDOW, RADIUS, (),
        None, 1e5, 10, 1.0, 60, 1.49e-8, 1.49e-8, False,
    )
    if batch is None:
        batch = example_batch(**batch_kwargs)
    state = from_reference(*batch[:5], device=device)
    return solver, (state.frames, state.frame_idx, state.params0,
                    state.pose0, state.valid)


def example_batch_3d(B=2048, shape=(64, 192, 192), pitch=(16, 24, 24),
                     seed=4, with_truth=False):
    """Config 4's scene (benchmarks/suite.py::config4), drawn the same way
    from the same seed: anisotropic dimers (sizes 1.5, 2.2, 2.2, separation
    4.5, signal 150), one per ``pitch`` cell of ``shape`` z-stacks, centers
    jittered by ±1, starts perturbed by ±0.25 px.  Returns (frames
    [T, Z, H, W], frame_idx, params0 [B, 2, 8], pose0, valid), plus the
    true positions [B, 2, 3] when ``with_truth``."""
    rng = np.random.default_rng(seed)
    n, P = 2, 8  # [bg, signal, z, y, x, size_z, size_y, size_x]
    per = tuple(s // p for s, p in zip(shape, pitch))
    per_frame = int(np.prod(per))
    T = -(-B // per_frame)
    frames = np.zeros((T,) + tuple(shape), np.float32)
    params0 = np.zeros((B, n, P), np.float32)
    truth = np.zeros((B, n, 3))
    fidx = np.zeros(B, np.int32)
    sizes = (1.5, 2.2, 2.2)
    for b in range(B):
        t = b // per_frame
        cell = b % per_frame
        iz = cell // (per[1] * per[2])
        iy = (cell // per[2]) % per[1]
        ix = cell % per[2]
        c = (np.array([iz * pitch[0] + 8, iy * pitch[1] + 12,
                       ix * pitch[2] + 12], float)
             + rng.uniform(-1, 1, 3))
        true = artificial.draw_cluster(
            frames[t], c, size=sizes, separation=4.5, n=n, signal=150.0,
            angle=rng.uniform(0, np.pi),
        )
        truth[b] = true
        params0[b, :, 1] = 150.0
        params0[b, :, 2:5] = true + rng.uniform(-0.25, 0.25, true.shape)
        params0[b, :, 5:8] = sizes
        fidx[b] = t
    pose0 = np.zeros((B, 0), np.float32)
    valid = np.ones(B, bool)
    out = (frames, fidx, params0, pose0, valid)
    return out + (truth,) if with_truth else out


def _rigid_configs():
    """The rigid cells: benchmarks/suite.py::config3 (2D dimers and
    trimers) and config3c (3D tetramers), and config 3b, which the
    reference names only (benchmarks/RESULTS.md:40, "3D rigid dimers
    (11×13×13 voxels, axis pose in-kernel, B=2048)"): drawn like config 3c
    with n = 2, ``dimer(5.0, 3)`` and size 2.0 (tests/test_pallas_lm.py's
    3D dimer), radius (5, 6, 6)."""
    two_d = dict(ndim=2, B=4096, shape=(256, 256), pitch=(24, 24),
                 size=2.0, jitter=0.3, radius=(4.5, 4.5))
    three_d = dict(ndim=3, B=2048, shape=(64, 192, 192), pitch=(16, 24, 24),
                   jitter=0.2)
    return {
        "3-dimer": dict(two_d, con=dimer(5.0, 2), window=(15, 15), seed=3),
        "3-trimer": dict(two_d, con=trimer(5.0, 2), window=(17, 17),
                         seed=3),
        "3b": dict(three_d, con=dimer(5.0, 3), window=(11, 13, 13),
                   radius=(5.0, 6.0, 6.0), size=2.0, seed=13),
        "3c": dict(three_d, con=tetramer(3.2), window=(16, 16, 16),
                   radius=(3.5, 3.5, 3.5), size=1.5, seed=11),
    }


RIGID_CONFIGS = tuple(_rigid_configs())


def example_batch_rigid(config, B=None, seed=None, with_truth=False):
    """A rigid cell's scene (``RIGID_CONFIGS``), drawn as
    benchmarks/suite.py draws configs 3 and 3c: one isotropic Gaussian
    cluster (separation = the constraint's distance, signal 150, a random
    angle) per pitch cell, centers jittered by ±1, starts perturbed by
    ±0.3 px (2D) or ±0.2 px (3D).  The suite draws its trimers from the
    rng its dimers leave; here each cell starts from its own seed.
    Returns (frames, frame_idx, params0, pose0 from ``positions_to_pose``,
    valid), plus the true positions [B, n, D] when ``with_truth``."""
    c = _rigid_configs()[config]
    con, D = c["con"], c["ndim"]
    n = con.cluster_size
    B = c["B"] if B is None else B
    rng = np.random.default_rng(c["seed"] if seed is None else seed)
    shape, pitch = c["shape"], c["pitch"]
    per = tuple(s // p for s, p in zip(shape, pitch))
    per_frame = int(np.prod(per))
    T = -(-B // per_frame)
    P = 3 + D   # [bg, signal, pos..., size]
    frames = np.zeros((T,) + tuple(shape), np.float32)
    params0 = np.zeros((B, n, P), np.float32)
    truth = np.zeros((B, n, D))
    fidx = np.zeros(B, np.int32)
    for b in range(B):
        t, cell = b // per_frame, b % per_frame
        idx = np.unravel_index(cell, per)
        center = np.array([i * p + p / 2 for i, p in zip(idx, pitch)],
                          float) + rng.uniform(-1, 1, D)
        true = artificial.draw_cluster(
            frames[t], center, size=c["size"], separation=con.dist, n=n,
            signal=150.0, angle=rng.uniform(0, np.pi))
        truth[b] = true
        params0[b, :, 1] = 150.0
        params0[b, :, 2:2 + D] = true + rng.uniform(-c["jitter"],
                                                    c["jitter"], true.shape)
        params0[b, :, 2 + D] = c["size"]
        fidx[b] = t
    pose0 = positions_to_pose(params0[:, :, 2:2 + D], con).astype(np.float32)
    out = (frames, fidx, params0, pose0, np.ones(B, bool))
    return out + (truth,) if with_truth else out


def entry_rigid(config, device, batch=None, lm_backend="auto",
                gather_backend="auto", streaming=None, **batch_kwargs):
    """(solve, example_args) for a rigid cell (``RIGID_CONFIGS``): the
    constrained bucket solver of suite.py's configuration (isotropic
    gauss, size const, refit-on-shift up to 10 rounds, up to 60 LM
    iterations) and ``batch`` (the five arrays of ``example_batch_rigid``,
    or ``example_batch_rigid(config, **batch_kwargs)``) as tensors on
    ``device``.  ``lm_backend``, ``gather_backend`` and ``streaming`` as
    ``_bucket_solver``'s."""
    c = _rigid_configs()[config]
    solver, _ = _bucket_solver(
        get_model("gauss"), c["ndim"], True, c["con"].cluster_size, (),
        c["window"], c["radius"], (), c["con"], 1e5, 10, 1.0, 60, 1.49e-8,
        1.49e-8, False, lm_backend, gather_backend, streaming,
    )
    if batch is None:
        batch = example_batch_rigid(config, **batch_kwargs)
    state = from_reference(*batch[:5], device=device)
    return solver, (state.frames, state.frame_idx, state.params0,
                    state.pose0, state.valid)


def entry_3d(device, batch=None, lm_backend="auto", gather_backend="auto",
             streaming=None, **batch_kwargs):
    """(solve, example_args) for config 4: the 3D anisotropic bucket
    solver and ``batch`` (the five arrays of ``example_batch_3d``, or
    ``example_batch_3d(**batch_kwargs)``) as tensors on ``device``.
    ``lm_backend``, ``gather_backend`` and ``streaming`` as
    ``_bucket_solver``'s."""
    solver, _ = _bucket_solver(
        get_model("gauss"), 3, False, 2, MODES_3D, WINDOW_3D, RADIUS_3D, (),
        None, 1e5, 10, 1.0, 60, 1.49e-8, 1.49e-8, False, lm_backend,
        gather_backend, streaming,
    )
    if batch is None:
        batch = example_batch_3d(**batch_kwargs)
    state = from_reference(*batch[:5], device=device)
    return solver, (state.frames, state.frame_idx, state.params0,
                    state.pose0, state.valid)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The public API over an ``n_devices``-shard mesh, on tiny shapes.

    The shards go on the visible CUDA cards in turn (four shards on one
    card share it), or all on the host with ``device="cpu"``; without a
    card and without ``device="cpu"`` this raises ``RuntimeError``.  It
    drives ``refine_leastsq(mesh=...)`` on a 2-frame dimer video with the
    size tied across every lane ('global'; the tie all-reduces across the
    shards) and checks that the tied size is identical on every accepted
    fit (ptp < 1e-5), then ``link(mesh=...)`` over ``4 * n_devices``
    frames of 6 walkers, frame-sharded with stitched cuts, and checks 6
    trajectories.  Prints one line and returns its numbers."""
    import pandas as pd
    import torch

    from .link import link
    from .parallel.sharding import make_mesh
    from .refine import refine_leastsq

    if device is not None and torch.device(device).type == "cpu":
        devices = ["cpu"] * n_devices
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dryrun_multichip: no CUDA device is available; pass "
                "device='cpu' to run the shards on the host")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    mesh = make_mesh(devices)

    # a tiny dimer video through the public refine entry point, with the
    # size shared across lanes on every shard
    rng = np.random.default_rng(0)
    T = 2
    frames = np.zeros((T, 48, 48), np.float32)
    rows = []
    for t in range(T):
        for c in [(14.0, 14.0), (14.0, 34.0), (34.0, 24.0)]:
            true = artificial.draw_cluster(
                frames[t], np.asarray(c), size=2.5, separation=5.0,
                n=2, signal=150.0, angle=rng.uniform(0, np.pi),
            )
            for p in true + rng.uniform(-0.3, 0.3, true.shape):
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 150.0})
    out = refine_leastsq(
        pd.DataFrame(rows), frames, diameter=9, separation=6.0,
        param_mode={"size": "global"}, param_val={"size": 2.5},
        mesh=mesh, lm_max_iter=8, max_iter=2,
    )
    ok = out["cost"].notna()
    if not ok.any():
        raise RuntimeError("dryrun_multichip: every sharded fit rejected")
    sizes = out.loc[ok, "size"].to_numpy()
    ptp = float(np.ptp(sizes))
    if ptp >= 1e-5:
        raise RuntimeError(f"dryrun_multichip: the global size is not tied "
                           f"across shards (ptp {ptp})")

    # frame-sharded linking with stitched cuts through the public link
    rng = np.random.default_rng(1)
    Tl, N = 4 * n_devices, 6
    pos = np.cumsum(
        np.concatenate([rng.uniform(10, 90, (1, N, 2)),
                        rng.normal(0, 0.3, (Tl - 1, N, 2))]),
        axis=0,
    )
    fl = pd.DataFrame({"frame": np.repeat(np.arange(Tl), N),
                       "y": pos[:, :, 0].ravel(), "x": pos[:, :, 1].ravel()})
    n_traj = int(link(fl, 3.0, mesh=mesh)["particle"].nunique())
    if n_traj != N:
        raise RuntimeError(f"dryrun_multichip: sharded link broke "
                           f"trajectories: {n_traj} != {N}")
    result = dict(shards=mesh.size, distinct_devices=len(mesh.distinct),
                  fits=int(ok.sum()), size_ptp=ptp, trajectories=n_traj,
                  frames=Tl)
    print(f"dryrun_multichip OK: {mesh.size} shards on "
          f"{len(mesh.distinct)} distinct device(s) "
          f"{[str(d) for d in mesh.distinct]} via the public API, "
          f"{result['fits']} fits, global size ptp {ptp:.2e}, sharded link "
          f"{n_traj} trajectories over {Tl} frames", flush=True)
    return result
