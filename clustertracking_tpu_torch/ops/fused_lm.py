"""Fused window-gather + LM solve for one bucket: the CUDA kernel, its
plain PyTorch version, and the routing predicate.

Counterpart of ``clustertracking_tpu/ops/pallas_lm.py``, whose
``kernel_fused`` (the TPU route for 2D unconstrained buckets) cuts each
cluster's window out of the frame stack and runs the whole masked
Levenberg–Marquardt solve in one launch.  Here:

- ``fused_lm_2d`` is the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/fused_lm_2d.cu`` (built for sm_90a on first
  use) and counts the launch in ``fused_lm_2d.launches``; on CPU tensors
  it returns the plain version's result.  It raises on anything the
  kernel does not take, and never swaps in the plain version for a CUDA
  tensor.
- ``fused_lm_2d_reference`` is the plain PyTorch version of the same
  function, built on ``ops/residual.py`` and ``ops/lm.py::lm_solve`` with
  the kernel's in-window fit mask.
- ``kernel_available`` is the static routing predicate that mirrors the
  reference's ``pallas_available``: buckets it rejects (global-tied slots,
  constraints, V >= 20) are solved by ``lm_solve``.

Both versions take the reference's ``solve_fused`` arguments::

    vect0 [B, V] f32, const_params [B, n, P] f32, frames [T, H, W] f32,
    frame_idx [B] i32, pos_at [B, n, 2] f32 (gather-time positions),
    origin [B, 2] i32 (clamped window corners), norm [B] f32,
    valid [B] bool, fvalid [B, n] f32 or None

and return ``LMResult(x, cost, n_iter, converged, npix)``.  Lanes with
``valid`` False are not solved: x is the clipped ``vect0`` and cost,
n_iter, converged and npix are 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.packing import ParamLayout, param_names_for
from ..models.registry import ModelSpec, get_model
from .gather import gather_stack
from .lm import LMResult, lm_solve
from .residual import make_model_fns, window_offsets

__all__ = ["check_kernel_args", "fused_lm_2d", "fused_lm_2d_reference",
           "kernel_available", "kernel_mask"]

# Unconstrained buckets with this many slots or more are solved by
# lm_solve (the reference's routing threshold, pallas_lm.py:235; still to
# be re-measured on the H100).
_KERNEL_MAX_SLOTS = 20
# Caps of csrc/fused_lm_2d.cu (kMaxSlots, kMaxFeatures).
_CUDA_MAX_SLOTS = 20
_CUDA_MAX_FEATURES = 32
# Largest window, in pixels, the reference's kernels take (its streaming
# cap, pallas_lm.py:148).
_MAX_WINDOW_PIXELS = 1 << 18


def kernel_available(model: ModelSpec, layout: ParamLayout,
                     use_global: bool, constraint,
                     window_shape=None) -> bool:
    """Whether the fused kernel route covers this bucket configuration.

    The same static routing as the reference's ``pallas_available``:
    cross-lane-tied 'global' slots, zero-slot layouts, buckets at or past
    ``_KERNEL_MAX_SLOTS`` and windows past ``_MAX_WINDOW_PIXELS`` go to
    ``lm_solve``.  Constrained buckets are refused before routing (the
    rigid kernels are not ported yet)."""
    if use_global or constraint is not None:
        return False
    if not 0 < layout.n_slots < _KERNEL_MAX_SLOTS:
        return False
    if window_shape is not None:
        if int(np.prod(window_shape)) > _MAX_WINDOW_PIXELS:
            return False
    return True


def kernel_mask(pos_at, origin, window_shape, radius, fvalid):
    """The kernel's fit mask, [B, Npix] f32: 1.0 where a pixel lies within
    ``radius`` of any live feature at its gather-time position.

    Computed as the reference kernel computes it, (off − rel)·(1/r) with
    1/r rounded to float32 (pallas_lm.py:515), which can differ from
    ``radius_mask``'s ``/ r`` on a pixel that sits on the boundary."""
    D = len(window_shape)
    off = window_offsets(window_shape, torch.float32, pos_at.device)
    rel = pos_at - origin[:, None, :].to(torch.float32)       # [B, n, D]
    r2 = None
    for d in range(D):
        inv_r = float(np.float32(1.0 / float(radius[d])))
        dm = (off[d][None, None] - rel[..., d, None]) * inv_r  # [B, n, Np]
        r2 = dm * dm if r2 is None else r2 + dm * dm
    hit = (r2 <= 1.0) & (fvalid[:, :, None] > 0.5)
    return torch.any(hit, dim=1).to(torch.float32)


def fused_lm_2d_reference(vect0, const_params, frames, frame_idx, pos_at,
                          origin, norm, valid, fvalid=None, *, model,
                          layout, window_shape, lo, hi, radius,
                          max_iter=60, ftol=1.49e-8, xtol=1.49e-8,
                          lam0=1e-3, lam_up=4.0, lam_down=0.25,
                          lam_max=1e10):
    """Plain PyTorch version of ``fused_lm_2d``: gather, kernel mask,
    ``lm_solve``.  Works for any profile and window rank, on any device."""
    device = frames.device
    B, n = vect0.shape[0], layout.n_features
    if fvalid is None:
        fvalid = torch.ones((B, n), dtype=torch.float32, device=device)
    fns = make_model_fns(model, layout, tuple(window_shape), device=device)
    pixels = gather_stack(frames, frame_idx, origin, tuple(window_shape))
    mask = kernel_mask(pos_at, origin, window_shape, radius, fvalid)
    res = lm_solve(
        fns.residual, fns.residual_jac, vect0,
        (const_params, pixels, mask, origin, norm, fvalid),
        max_iter=max_iter, ftol=ftol, xtol=xtol, lam0=lam0, lam_up=lam_up,
        lam_down=lam_down, lam_max=lam_max,
        lower=torch.as_tensor(np.asarray(lo, np.float32), device=device),
        upper=torch.as_tensor(np.asarray(hi, np.float32), device=device),
        valid=valid,
    )
    return LMResult(
        x=res.x,
        cost=torch.where(valid, res.cost, 0.0),
        n_iter=res.n_iter,
        converged=res.converged,
        npix=torch.where(valid, mask.sum(dim=1), 0.0),
    )


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]  # frames
    + [ctypes.c_void_p] * 11        # frame_idx .. hi
    + [ctypes.c_int] * 7            # B, n, P, V, iso, wy, wx
    + [ctypes.c_float] * 2          # inv_ry, inv_rx
    + [ctypes.c_int]                # max_iter
    + [ctypes.c_float] * 7          # ftol .. plateau
    + [ctypes.c_void_p] * 5         # outputs
    + [ctypes.c_void_p]             # stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("fused_lm_2d")
    if lib.fused_lm_2d_launch.argtypes is None:
        lib.fused_lm_2d_launch.argtypes = _ARGTYPES
        lib.fused_lm_2d_launch.restype = ctypes.c_int
        lib.fused_lm_2d_smem_words.argtypes = [ctypes.c_int]
        lib.fused_lm_2d_smem_words.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"fused_lm_2d: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"fused_lm_2d: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused_lm_2d: {name} has shape {tuple(t.shape)}, "
            f"expected {tuple(shape)}"
        )
    if t.device != device:
        raise ValueError(
            f"fused_lm_2d: {name} is on {t.device}, frames on {device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_lm_2d: {name} must be contiguous")


def check_kernel_args(vect0, const_params, frames, frame_idx, pos_at,
                      origin, norm, valid, fvalid, *, model, layout,
                      window_shape):
    """Raise on anything ``csrc/fused_lm_2d.cu`` does not take: a profile
    other than 'gauss' or a 3D window (``NotImplementedError``: the TPU ran
    those in Pallas, the port has no kernel for them yet), a parameter
    layout, slot or feature count outside the kernel's, and tensors of the
    wrong dtype, shape, device or layout."""
    if model is not get_model("gauss"):
        raise NotImplementedError(
            f"fused_lm_2d: profile {model.name!r} has no CUDA kernel yet "
            "(ROADMAP queue 2: non-gauss profiles in csrc/fused_lm_2d.cu)"
        )
    if len(window_shape) != 2 or layout.ndim != 2:
        raise NotImplementedError(
            "fused_lm_2d: 3D windows have no CUDA kernel yet (ROADMAP "
            "queue 2 item 2: pallas_lm.py `kernel`)"
        )
    if tuple(layout.param_names) != tuple(
            param_names_for(model, 2, layout.isotropic)):
        raise ValueError("fused_lm_2d: unexpected parameter layout")
    B, V = vect0.shape
    n, P = layout.n_features, layout.n_params
    if not 0 < V <= _CUDA_MAX_SLOTS or V != layout.n_slots:
        raise ValueError(f"fused_lm_2d: V={V} slots outside the kernel's "
                         f"1..{_CUDA_MAX_SLOTS}")
    if n > _CUDA_MAX_FEATURES:
        raise ValueError(f"fused_lm_2d: n={n} features > "
                         f"{_CUDA_MAX_FEATURES}")
    if frames.dim() != 3:
        raise ValueError("fused_lm_2d: frames must be [T, H, W]")
    T, H, W = frames.shape
    if window_shape[0] > H or window_shape[1] > W:
        raise ValueError(f"fused_lm_2d: window {window_shape} exceeds "
                         f"frame {(H, W)}")
    device = frames.device
    f32, i32 = torch.float32, torch.int32
    _check("frames", frames, f32, (T, H, W), device)
    _check("vect0", vect0, f32, (B, V), device)
    _check("const_params", const_params, f32, (B, n, P), device)
    _check("frame_idx", frame_idx, i32, (B,), device)
    _check("pos_at", pos_at, f32, (B, n, 2), device)
    _check("origin", origin, i32, (B, 2), device)
    _check("norm", norm, f32, (B,), device)
    _check("valid", valid, torch.bool, (B,), device)
    _check("fvalid", fvalid, f32, (B, n), device)


def fused_lm_2d(vect0, const_params, frames, frame_idx, pos_at, origin,
                norm, valid, fvalid=None, *, model, layout, window_shape,
                lo, hi, radius, max_iter=60, ftol=1.49e-8, xtol=1.49e-8,
                lam0=1e-3, lam_up=4.0, lam_down=0.25, lam_max=1e10):
    """Fused gather + LM solve of one bucket (see the module docstring).

    CUDA tensors launch ``csrc/fused_lm_2d.cu``; CPU tensors get
    ``fused_lm_2d_reference``.  Raises ``NotImplementedError`` on CUDA for
    what the TPU ran in Pallas but this port has no kernel for yet: a
    profile other than 'gauss' and 3D windows."""
    kw = dict(model=model, layout=layout, window_shape=window_shape, lo=lo,
              hi=hi, radius=radius, max_iter=max_iter, ftol=ftol,
              xtol=xtol, lam0=lam0, lam_up=lam_up, lam_down=lam_down,
              lam_max=lam_max)
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
                      layout=layout, window_shape=window_shape)
    B, V = vect0.shape
    n, P = layout.n_features, layout.n_params
    T, H, W = frames.shape
    wy, wx = (int(w) for w in window_shape)
    f32, i32 = torch.float32, torch.int32
    lib = _library()
    npix_cap = (200 * 1024 // 4 - lib.fused_lm_2d_smem_words(0)) // 2
    if wy * wx > npix_cap:
        raise NotImplementedError(
            f"fused_lm_2d: a {wy}x{wx} window does not fit shared memory "
            "(ROADMAP queue 2 item 3: the streaming kernel)"
        )
    valid_i = valid.to(i32)
    slot_idx = torch.as_tensor(layout.slot_idx, dtype=i32, device=device)
    lo_t = torch.as_tensor(np.asarray(lo, np.float32), device=device)
    hi_t = torch.as_tensor(np.asarray(hi, np.float32), device=device)
    x_out = torch.empty((B, V), dtype=f32, device=device)
    cost = torch.empty((B,), dtype=f32, device=device)
    n_iter = torch.empty((B,), dtype=i32, device=device)
    conv = torch.empty((B,), dtype=i32, device=device)
    npix = torch.empty((B,), dtype=f32, device=device)
    inv_r = [float(np.float32(1.0 / float(r))) for r in radius]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fused_lm_2d_launch(
            frames.data_ptr(), T, H, W,
            frame_idx.data_ptr(), origin.data_ptr(), vect0.data_ptr(),
            const_params.data_ptr(), pos_at.data_ptr(), norm.data_ptr(),
            valid_i.data_ptr(), fvalid.data_ptr(), slot_idx.data_ptr(),
            lo_t.data_ptr(), hi_t.data_ptr(),
            B, n, P, V, int(layout.isotropic), wy, wx,
            inv_r[0], inv_r[1], int(max_iter), float(ftol), float(xtol),
            float(lam0), float(lam_up), float(lam_down), float(lam_max),
            float(1e6 * lam0),
            x_out.data_ptr(), cost.data_ptr(), n_iter.data_ptr(),
            conv.data_ptr(), npix.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_lm_2d: kernel launch failed, "
                           f"cudaError {rc}")
    fused_lm_2d.launches += 1
    return LMResult(x=x_out, cost=cost, n_iter=n_iter,
                    converged=conv.to(torch.bool), npix=npix)


fused_lm_2d.launches = 0
