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
"""
from __future__ import annotations

import numpy as np

from . import artificial
from .interop import from_reference
from .models.registry import get_model
from .refine import _bucket_solver

__all__ = ["example_batch", "example_batch_3d", "entry", "entry_3d",
           "WINDOW", "RADIUS", "WINDOW_3D", "RADIUS_3D", "MODES_3D"]

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
