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

With ``rounds`` (an int ≥ 1) both run the bucket solver's refit-on-shift
loop instead (``refine.py::_shard_solver``; ``pos_at`` and ``origin`` are
then None): each round centres every cluster's window on its positions
at the current x (``origins_for``; a rigid bucket's from its pose), cuts
it and solves it, and a cluster goes round again while a position moved
more than ``max_shift``, up to ``rounds`` rounds.  They return
``RefitResult``: the round of least rms = sqrt(cost / npix) of each
cluster (an empty mask fails), its x, converged, cost and npix, and the
LM iterations of all its rounds; a cluster with no such round, or not
``valid``, keeps ``vect0`` with rms inf and cost, converged and npix 0.
On CUDA the whole loop runs inside the kernel, one warp a cluster, and
nothing is read back to the host; the plain version runs it on the host
(``refit_on_host``).  The kernel adds each cluster's rounds past the
first to a device counter, ``fused_lm_2d.refits[device]`` ([1] int64;
``diagnostics.refit_rounds`` reads it), and the wrapper counts the launch
in ``fused_lm_2d.launches_looped`` too.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..constraints import pose_dim, pose_to_positions
from .gather import gather_stack, origins_for
from .lm import LMResult
from .pixel_lm import (
    MODEL_ARGTYPES, POSE_NGON_2D, check_pixel_lm_args, kernel_mask,
    KernelProblem, pixel_lm_reference)
from .pixel_lm import smem_words as _smem_words
from .window_gather import check_tensor

__all__ = ["RefitResult", "check_kernel_args", "fused_lm_2d",
           "fused_lm_2d_reference", "fused_max_pixels", "kernel_mask",
           "refit_on_host"]

# csrc/fused_lm_2d.cu's kLoopWords: the refit loop's per-warp words (two
# position tables of kMaxFeatures × 2, the best x, five scalars)
_LOOP_WORDS = 4 * 32 + 20 + 5


class RefitResult(NamedTuple):
    """The refit loop's outputs a cluster: the best round's x, cost,
    converged and npix, the LM iterations of every round, and the best
    round's rms (inf where no round had a finite one)."""

    x: torch.Tensor          # [B, V]
    cost: torch.Tensor       # [B]
    n_iter: torch.Tensor     # [B] int32, summed over the rounds
    converged: torch.Tensor  # [B] bool
    npix: torch.Tensor       # [B]
    rms: torch.Tensor        # [B]


def _warp_words(npix, profile=0, pose=0):
    """Per-warp shared memory of a ``fused_lm_2d`` launch, in 4-byte words
    (``fused_lm_2d_smem_words``): the pixel list, the refit loop's words
    and the LM core."""
    return 2 * int(npix) + _LOOP_WORDS + _smem_words(2, 0, True, profile,
                                                     pose)


def fused_max_pixels(profile=0, pose=0):
    """The largest window, in pixels, ``fused_lm_2d`` holds for a profile
    tag and pose kind (gauss, unconstrained: ~24.5k): csrc/fused_lm_2d.cu
    stages a window of wy·wx pixels and its weights in shared memory
    beside the refit loop's words and the LM core, within 200 KB per
    block."""
    return (200 * 1024 // 4 - _warp_words(0, profile, pose)) // 2


def refit_on_host(solve, vect0, const_params, frames, frame_idx, norm,
                  valid, fvalid=None, *, rounds, max_shift, **kw):
    """The refit-on-shift loop on the host around ``solve`` (one round:
    ``fused_lm_2d``'s or ``fused_lm_2d_reference``'s single solve, with the
    keywords ``kw``): the plain version of the kernel's loop, and the
    loop the bucket solver runs on the host
    (``refine.py::_shard_solver``), for one shard.  Returns
    ``RefitResult``."""
    layout, constraint = kw["layout"], kw.get("constraint")
    window_shape = tuple(kw["window_shape"])
    frame_shape = tuple(frames.shape[1:])
    p0 = layout.pos_param_idx[0]

    def positions(v):
        if constraint is None:
            return layout.vect_to_params(v, const_params)[
                ..., p0:p0 + layout.ndim]
        return pose_to_positions(
            v[:, :pose_dim(constraint) + int(constraint.fit_dist)],
            constraint)

    B, device = vect0.shape[0], vect0.device
    vect, need = vect0, valid
    x_best, iters = vect0, torch.zeros((B,), dtype=torch.int32,
                                       device=device)
    rms_best = torch.full((B,), torch.inf, device=device)
    cost_best = torch.zeros((B,), device=device)
    npix_best = torch.zeros((B,), device=device)
    conv_best = torch.zeros((B,), dtype=torch.bool, device=device)
    for it in range(max(int(rounds), 1)):
        if it > 0 and not bool(need.any()):
            break
        pos_at = positions(vect).contiguous()
        origin = origins_for(pos_at, window_shape, frame_shape)
        res = solve(vect, const_params, frames, frame_idx, pos_at, origin,
                    norm, need, fvalid, **kw)
        shift = torch.amax(torch.abs(positions(res.x) - pos_at), dim=(1, 2))
        rms = torch.where(res.npix > 0.0, torch.sqrt(
            res.cost / torch.clamp(res.npix, min=1.0)), torch.inf)
        iters = iters + torch.where(need, res.n_iter, 0)
        improved = need & (rms < rms_best)
        x_best = torch.where(improved[:, None], res.x, x_best)
        rms_best = torch.where(improved, rms, rms_best)
        cost_best = torch.where(improved, res.cost, cost_best)
        npix_best = torch.where(improved, res.npix, npix_best)
        conv_best = torch.where(improved, res.converged, conv_best)
        need = need & (shift > max_shift)
        vect = res.x
    return RefitResult(x=x_best, cost=cost_best, n_iter=iters,
                       converged=conv_best, npix=npix_best, rms=rms_best)


def fused_lm_2d_reference(vect0, const_params, frames, frame_idx, pos_at,
                          origin, norm, valid, fvalid=None, *, model,
                          layout, window_shape, bounds, radius,
                          max_iter=60, ftol=1.49e-8, xtol=1.49e-8,
                          lam0=1e-3, lam_up=4.0, lam_down=0.25,
                          lam_max=1e10, constraint=None, rounds=None,
                          max_shift=1.0):
    """Plain PyTorch version of ``fused_lm_2d``: ``gather_stack``, then
    ``pixel_lm_reference``; with ``rounds``, ``refit_on_host`` around
    that.  Works for any profile, constraint and window rank, on any
    device."""
    kw = dict(model=model, layout=layout, window_shape=window_shape,
              bounds=bounds, radius=radius, max_iter=max_iter, ftol=ftol,
              xtol=xtol, lam0=lam0, lam_up=lam_up, lam_down=lam_down,
              lam_max=lam_max, constraint=constraint)
    if rounds is not None:
        return refit_on_host(fused_lm_2d_reference, vect0, const_params,
                             frames, frame_idx, norm, valid, fvalid,
                             rounds=rounds, max_shift=max_shift, **kw)
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
    + [ctypes.c_int, ctypes.c_float]  # rounds, max_shift
    + [ctypes.c_int]                # max_iter
    + [ctypes.c_float] * 7          # ftol .. plateau
    + MODEL_ARGTYPES                # prof .. xn
    + [ctypes.c_void_p] * 7         # outputs, the refit counter
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
                if lib.fused_lm_2d_smem_words(100, prof, pose) != \
                        _warp_words(100, prof, pose):
                    raise RuntimeError("fused_lm_2d: shared memory per warp "
                                       "disagrees with csrc/fused_lm_2d.cu")
    return lib


def check_kernel_args(vect0, const_params, frames, frame_idx, pos_at,
                      origin, norm, valid, fvalid, *, model, layout,
                      window_shape, bounds, constraint=None, rounds=None):
    """Raise on anything ``csrc/fused_lm_2d.cu`` does not take: a custom
    model (``NotImplementedError``: no kernel evaluates a Python
    callable), a window other than 2D (3D buckets take the gathered
    route), a constraint the rigid kernel does not inline, a parameter
    layout, slot or feature count outside the kernel's, bounds built for
    another configuration or device, tensors of the wrong dtype, shape,
    device or layout, ``pos_at`` and ``origin`` given with ``rounds`` (the
    loop centres the windows itself) or missing without, and ``rounds``
    below 1."""
    if rounds is None:
        if pos_at is None or origin is None:
            raise ValueError("fused_lm_2d: one solve needs pos_at and "
                             "origin (or rounds, for the refit loop)")
    elif pos_at is not None or origin is not None:
        raise ValueError("fused_lm_2d: the refit loop centres each window "
                         "itself; pass pos_at and origin as None")
    elif int(rounds) < 1:
        raise ValueError(f"fused_lm_2d: rounds={rounds}; at least 1")
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
                constraint=None, rounds=None, max_shift=1.0):
    """Fused gather + LM solve of one bucket, or with ``rounds`` its whole
    refit loop (see the module docstring).

    CUDA tensors launch ``csrc/fused_lm_2d.cu`` with the model's profile
    and, for a rigid ``constraint``, its n-gon pose inlined; CPU tensors
    get ``fused_lm_2d_reference``.  Raises ``NotImplementedError`` on CUDA
    for a custom model, which no kernel evaluates.  On CUDA it copies
    nothing from the host and reads nothing back."""
    kw = dict(model=model, layout=layout, window_shape=window_shape,
              bounds=bounds, radius=radius, max_iter=max_iter, ftol=ftol,
              xtol=xtol, lam0=lam0, lam_up=lam_up, lam_down=lam_down,
              lam_max=lam_max, constraint=constraint)
    device = frames.device
    if device.type == "cpu":
        return fused_lm_2d_reference(
            vect0, const_params, frames, frame_idx, pos_at, origin, norm,
            valid, fvalid, rounds=rounds, max_shift=max_shift, **kw,
        )
    if device.type != "cuda":
        raise ValueError(f"fused_lm_2d: unsupported device {device}")
    if fvalid is None:
        fvalid = torch.ones((vect0.shape[0], layout.n_features),
                            dtype=torch.float32, device=device)
    check_kernel_args(vect0, const_params, frames, frame_idx, pos_at,
                      origin, norm, valid, fvalid, model=model,
                      layout=layout, window_shape=window_shape,
                      bounds=bounds, constraint=constraint, rounds=rounds)
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
    looped = rounds is not None
    rms = torch.empty((B,), dtype=f32, device=device) if looped else None
    if looped and device not in fused_lm_2d.refits:
        fused_lm_2d.refits[device] = torch.zeros((1,), dtype=torch.int64,
                                                 device=device)
    refits = fused_lm_2d.refits[device] if looped else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    inv_r = [float(np.float32(1.0 / float(r))) for r in radius]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fused_lm_2d_launch(
            frames.data_ptr(), T, H, W,
            frame_idx.data_ptr(), ptr(origin), kp.x0.data_ptr(),
            const_params.data_ptr(), ptr(pos_at), norm.data_ptr(),
            valid_i.data_ptr(), fvalid.data_ptr(),
            kp.kernel.slot_idx.data_ptr(),
            kp.kernel.lo.data_ptr(), kp.kernel.hi.data_ptr(),
            B, n, P, Vk, int(layout.isotropic), wy, wx,
            inv_r[0], inv_r[1], int(rounds) if looped else 0,
            float(max_shift), int(max_iter), float(ftol), float(xtol),
            float(lam0), float(lam_up), float(lam_down), float(lam_max),
            float(1e6 * lam0), *kp.args(),
            x_out.data_ptr(), cost.data_ptr(), n_iter.data_ptr(),
            conv.data_ptr(), npix.data_ptr(), ptr(rms), ptr(refits), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_lm_2d: kernel launch failed, "
                           f"cudaError {rc}")
    fused_lm_2d.launches += 1
    if not looped:
        return LMResult(x=kp.expand(x_out), cost=cost, n_iter=n_iter,
                        converged=conv.to(torch.bool), npix=npix)
    fused_lm_2d.launches_looped += 1
    return RefitResult(x=kp.expand(x_out), cost=cost, n_iter=n_iter,
                       converged=conv.to(torch.bool), npix=npix, rms=rms)


fused_lm_2d.launches = 0
fused_lm_2d.launches_looped = 0
# device -> [1] int64: the refit rounds past each cluster's first that the
# looped kernel ran there (one atomicAdd a cluster that refits)
fused_lm_2d.refits = {}
