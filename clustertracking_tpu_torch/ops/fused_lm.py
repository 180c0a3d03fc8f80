"""Fused window-gather + LM solve for one 2D bucket: the CUDA kernel and its
plain version.

Counterpart of ``clustertracking_tpu/ops/pallas_lm.py``, whose
``kernel_fused`` (the TPU route for 2D buckets, rigid ones included) cuts
each cluster's window out of the frame stack and runs the whole masked
Levenberg–Marquardt solve in one launch.  Here:

- ``fused_lm_2d`` is the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/fused_lm_2d.cu`` (built for sm_90a on first
  use; every built-in profile, and a rigid 2D n-gon pose when given a
  ``constraint``) and counts the launch in ``fused_lm_2d.launches``; on
  CPU tensors it returns the plain version's result.  It raises on
  anything the kernel does not take, and never swaps in the plain version
  for a CUDA tensor.
- ``fused_lm_2d_reference`` is the plain PyTorch version of the same
  function: ``gather_stack`` then ``pixel_lm_reference``.
- ``fused_max_pixels`` is the largest window the kernel holds
  (``refine.py::kernel_route`` routes larger ones elsewhere).

Both versions take the reference's ``solve_fused`` arguments::

    vect0 [B, V] f32, const_params [B, n, P] f32, frames [T, H, W] f32,
    frame_idx [B] i32, pos_at [B, n, 2] f32 (gather-time positions),
    origin [B, 2] i32 (clamped window corners), norm [B] f32,
    valid [B] bool, fvalid [B, n] f32 or None

and ``bounds`` (``ops/pixel_lm.py::SlotBounds``; a rigid ``constraint``:
vect0 [B, Qt + V] over refine.py's rigid layout) and return
``LMResult(x, cost, n_iter, converged, npix)``.  Lanes with ``valid``
False are not solved: x is the clipped ``vect0`` and cost, n_iter,
converged and npix are 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .gather import gather_stack
from .lm import LMResult
from .pixel_lm import (
    MODEL_ARGTYPES, POSE_NGON_2D, check_pixel_lm_args, kernel_mask,
    KernelProblem, pixel_lm_reference)
from .pixel_lm import smem_words as _smem_words
from .window_gather import check_tensor

__all__ = ["check_kernel_args", "fused_lm_2d", "fused_lm_2d_reference",
           "fused_max_pixels", "kernel_mask"]


def fused_max_pixels(profile=0, pose=0):
    """The largest window, in pixels, ``fused_lm_2d`` holds for a profile
    tag and pose kind (gauss, unconstrained: ~24.6k): csrc/fused_lm_2d.cu
    stages a window of wy·wx pixels and its weights in shared memory
    beside the LM core, within 200 KB per block."""
    return (200 * 1024 // 4 - _smem_words(2, 0, True, profile, pose)) // 2


def fused_lm_2d_reference(vect0, const_params, frames, frame_idx, pos_at,
                          origin, norm, valid, fvalid=None, *, model,
                          layout, window_shape, bounds, radius,
                          max_iter=60, ftol=1.49e-8, xtol=1.49e-8,
                          lam0=1e-3, lam_up=4.0, lam_down=0.25,
                          lam_max=1e10, constraint=None):
    """Plain PyTorch version of ``fused_lm_2d``: ``gather_stack``, then
    ``pixel_lm_reference``.  Works for any profile, constraint and window
    rank, on any device."""
    pixels = gather_stack(frames, frame_idx, origin, tuple(window_shape))
    return pixel_lm_reference(
        vect0, const_params, pixels, pos_at, origin, norm, valid, fvalid,
        model=model, layout=layout, window_shape=window_shape, bounds=bounds,
        radius=radius, max_iter=max_iter, ftol=ftol, xtol=xtol, lam0=lam0,
        lam_up=lam_up, lam_down=lam_down, lam_max=lam_max,
        constraint=constraint,
    )


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]  # frames
    + [ctypes.c_void_p] * 11        # frame_idx .. hi
    + [ctypes.c_int] * 7            # B, n, P, V, iso, wy, wx
    + [ctypes.c_float] * 2          # inv_ry, inv_rx
    + [ctypes.c_int]                # max_iter
    + [ctypes.c_float] * 7          # ftol .. plateau
    + MODEL_ARGTYPES                # prof .. xn
    + [ctypes.c_void_p] * 5         # outputs
    + [ctypes.c_void_p]             # stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("fused_lm_2d")
    if lib.fused_lm_2d_launch.argtypes is None:
        lib.fused_lm_2d_launch.argtypes = _ARGTYPES
        lib.fused_lm_2d_launch.restype = ctypes.c_int
        lib.fused_lm_2d_smem_words.argtypes = [ctypes.c_int] * 3
        lib.fused_lm_2d_smem_words.restype = ctypes.c_int
        for prof in range(5):
            for pose in (0, POSE_NGON_2D):
                if lib.fused_lm_2d_smem_words(0, prof, pose) != _smem_words(
                        2, 0, True, prof, pose):
                    raise RuntimeError("fused_lm_2d: shared memory per warp "
                                       "disagrees with csrc/fused_lm_2d.cu")
    return lib


def check_kernel_args(vect0, const_params, frames, frame_idx, pos_at,
                      origin, norm, valid, fvalid, *, model, layout,
                      window_shape, bounds, constraint=None):
    """Raise on anything ``csrc/fused_lm_2d.cu`` does not take: a custom
    model (``NotImplementedError``: no kernel evaluates a Python
    callable), a window other than 2D (3D buckets take the gathered
    route), a constraint the rigid kernel does not inline, a parameter
    layout, slot or feature count outside the kernel's, bounds built for
    another configuration or device, and tensors of the wrong dtype, shape,
    device or layout."""
    if len(window_shape) != 2 or layout.ndim != 2:
        raise ValueError(
            "fused_lm_2d: takes 2D windows; 3D buckets take the gathered "
            "route (window_gather, then pixel_lm)"
        )
    if frames.dim() != 3:
        raise ValueError("fused_lm_2d: frames must be [T, H, W]")
    T, H, W = frames.shape
    if window_shape[0] > H or window_shape[1] > W:
        raise ValueError(f"fused_lm_2d: window {window_shape} exceeds "
                         f"frame {(H, W)}")
    check_pixel_lm_args(vect0, const_params, None, pos_at, origin, norm,
                        valid, fvalid, model=model, layout=layout,
                        window_shape=window_shape, bounds=bounds,
                        who="fused_lm_2d", constraint=constraint)
    device = frames.device
    check_tensor("fused_lm_2d", "frames", frames, torch.float32, (T, H, W),
                 device)
    check_tensor("fused_lm_2d", "frame_idx", frame_idx, torch.int32,
                 (vect0.shape[0],), device)


def fused_lm_2d(vect0, const_params, frames, frame_idx, pos_at, origin,
                norm, valid, fvalid=None, *, model, layout, window_shape,
                bounds, radius, max_iter=60, ftol=1.49e-8, xtol=1.49e-8,
                lam0=1e-3, lam_up=4.0, lam_down=0.25, lam_max=1e10,
                constraint=None):
    """Fused gather + LM solve of one bucket (see the module docstring).

    CUDA tensors launch ``csrc/fused_lm_2d.cu`` with the model's profile
    and, for a rigid ``constraint``, its n-gon pose inlined; CPU tensors
    get ``fused_lm_2d_reference``.  Raises ``NotImplementedError`` on CUDA
    for a custom model, which no kernel evaluates."""
    kw = dict(model=model, layout=layout, window_shape=window_shape,
              bounds=bounds, radius=radius, max_iter=max_iter, ftol=ftol,
              xtol=xtol, lam0=lam0, lam_up=lam_up, lam_down=lam_down,
              lam_max=lam_max, constraint=constraint)
    device = frames.device
    if device.type == "cpu":
        return fused_lm_2d_reference(
            vect0, const_params, frames, frame_idx, pos_at, origin, norm,
            valid, fvalid, **kw,
        )
    if device.type != "cuda":
        raise ValueError(f"fused_lm_2d: unsupported device {device}")
    if fvalid is None:
        fvalid = torch.ones((vect0.shape[0], layout.n_features),
                            dtype=torch.float32, device=device)
    check_kernel_args(vect0, const_params, frames, frame_idx, pos_at,
                      origin, norm, valid, fvalid, model=model,
                      layout=layout, window_shape=window_shape,
                      bounds=bounds, constraint=constraint)
    B = vect0.shape[0]
    n, P = layout.n_features, layout.n_params
    T, H, W = frames.shape
    wy, wx = (int(w) for w in window_shape)
    f32, i32 = torch.float32, torch.int32
    kp = KernelProblem(vect0, model, bounds)
    if wy * wx > fused_max_pixels(kp.profile, kp.kernel.pose):
        raise ValueError(
            f"fused_lm_2d: a {wy}x{wx} window does not fit shared memory; "
            "such buckets take the gathered route (kernel_route)"
        )
    lib = _library()
    valid_i = valid.to(i32)
    Vk = kp.x0.shape[1]
    x_out = torch.empty((B, Vk), dtype=f32, device=device)
    cost = torch.empty((B,), dtype=f32, device=device)
    n_iter = torch.empty((B,), dtype=i32, device=device)
    conv = torch.empty((B,), dtype=i32, device=device)
    npix = torch.empty((B,), dtype=f32, device=device)
    inv_r = [float(np.float32(1.0 / float(r))) for r in radius]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fused_lm_2d_launch(
            frames.data_ptr(), T, H, W,
            frame_idx.data_ptr(), origin.data_ptr(), kp.x0.data_ptr(),
            const_params.data_ptr(), pos_at.data_ptr(), norm.data_ptr(),
            valid_i.data_ptr(), fvalid.data_ptr(),
            kp.kernel.slot_idx.data_ptr(),
            kp.kernel.lo.data_ptr(), kp.kernel.hi.data_ptr(),
            B, n, P, Vk, int(layout.isotropic), wy, wx,
            inv_r[0], inv_r[1], int(max_iter), float(ftol), float(xtol),
            float(lam0), float(lam_up), float(lam_down), float(lam_max),
            float(1e6 * lam0), *kp.args(),
            x_out.data_ptr(), cost.data_ptr(), n_iter.data_ptr(),
            conv.data_ptr(), npix.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_lm_2d: kernel launch failed, "
                           f"cudaError {rc}")
    fused_lm_2d.launches += 1
    return LMResult(x=kp.expand(x_out), cost=cost, n_iter=n_iter,
                    converged=conv.to(torch.bool), npix=npix)


fused_lm_2d.launches = 0
