"""LM solve of one bucket on windows gathered beforehand: the CUDA kernel,
its plain version and the kernel's fit mask.

Counterpart of ``clustertracking_tpu/ops/pallas_lm.py::make_pallas_lm``'s
``solve`` (its ``kernel`` with pixels resident, and ``kernel_stream`` with
pixels read from HBM on every sweep): the TPU route for 3D buckets and for
windows the fused 2D kernel cannot hold.  Here:

- ``pixel_lm`` is the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/pixel_lm.cu`` (built for sm_90a on first use)
  in one of two modes, and counts the launch in
  ``pixel_lm.launches_resident`` or ``pixel_lm.launches_streamed``; on CPU
  tensors it returns the plain version's result.  It raises on anything
  the kernel does not take, and never swaps in the plain version for a
  CUDA tensor.
- ``pixel_lm_reference`` is the plain PyTorch version: ``kernel_mask`` and
  ``ops/lm.py::lm_solve`` on the model of ``ops/residual.py``.
- ``kernel_mask`` is the fit mask every LM kernel of the port builds.

Modes (``streaming``): resident keeps each warp's in-mask voxels and their
values in shared memory; streamed keeps the voxel list in a global scratch
and reads values from ``pixels`` on every sweep.  ``streaming=None`` picks
by occupancy, the budget that decides the speed on an H100: resident
unless its shared memory holds fewer warps per SM than streamed, whose
warps are bound by registers (CUDA's occupancy calculator, per device and
window).  Config 4's 9×13×13 window needs 20.5 KB per warp resident, which
holds 8 warps per SM against streamed's 16, so it streams: 14.9 ms against
24.8 ms per launch at B=16,384 (NVIDIA H100 80GB HBM3, 700 W).

Both versions take the reference ``solve``'s arguments::

    vect0 [B, V] f32, const_params [B, n, P] f32, pixels [B, Npix] f32,
    pos_at [B, n, D] f32 (gather-time positions), origin [B, D] i32,
    norm [B] f32, valid [B] bool, fvalid [B, n] f32 or None

and return ``LMResult(x, cost, n_iter, converged, npix)``.  Lanes with
``valid`` False are not solved: x is the clipped ``vect0`` and cost,
n_iter, converged and npix are 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.packing import param_names_for
from ..models.registry import get_model
from .lm import LMResult, lm_solve
from .residual import make_model_fns, window_offsets
from .window_gather import check_tensor

__all__ = ["check_pixel_lm_args", "kernel_mask", "occupancy", "pixel_lm",
           "pixel_lm_reference", "pick_streaming"]

# Caps of csrc/lm_core.cuh (kMaxSlots, kMaxFeatures).
_CUDA_MAX_SLOTS = 20
_CUDA_MAX_FEATURES = 32
# (device index, window shape) -> streaming=None's choice
_MODE_CHOICE = {}


def kernel_mask(pos_at, origin, window_shape, radius, fvalid):
    """The kernels' fit mask, [B, Npix] f32: 1.0 where a pixel lies within
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


def pixel_lm_reference(vect0, const_params, pixels, pos_at, origin, norm,
                       valid, fvalid=None, *, model, layout, window_shape,
                       lo, hi, radius, max_iter=60, ftol=1.49e-8,
                       xtol=1.49e-8, lam0=1e-3, lam_up=4.0, lam_down=0.25,
                       lam_max=1e10):
    """Plain PyTorch version of ``pixel_lm``: kernel mask, ``lm_solve``.
    Works for any profile and window rank, on any device."""
    device = pixels.device
    B, n = vect0.shape[0], layout.n_features
    if fvalid is None:
        fvalid = torch.ones((B, n), dtype=torch.float32, device=device)
    fns = make_model_fns(model, layout, tuple(window_shape), device=device)
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


def smem_words(ndim, npix, streamed):
    """Per-warp shared memory of ``csrc/pixel_lm.cu`` in a mode, in 4-byte
    words (``pixel_lm_smem_words``): the LM core of ``lm_core.cuh`` plus,
    resident, the voxel list and its values."""
    feat_f, feat_i = 2 + 2 * ndim, 1 + 2 * ndim
    core = (32 * (_CUDA_MAX_SLOTS + 1)
            + 2 * (1 + _CUDA_MAX_SLOTS
                   + _CUDA_MAX_SLOTS * (_CUDA_MAX_SLOTS + 1) // 2)
            + 3 * _CUDA_MAX_SLOTS
            + _CUDA_MAX_FEATURES * feat_f + 1 + _CUDA_MAX_FEATURES * feat_i
            + _CUDA_MAX_SLOTS * _CUDA_MAX_SLOTS)
    return core + (0 if streamed else 2 * int(npix))


def pick_streaming(warps):
    """``streaming=None``'s choice from ``occupancy``'s warps per SM: stream
    when resident holds fewer warps per SM (0: it does not fit at all)."""
    return warps["resident"] < warps["streamed"]


def check_pixel_lm_args(vect0, const_params, pixels, pos_at, origin, norm,
                        valid, fvalid, *, model, layout, window_shape,
                        who="pixel_lm"):
    """Raise on anything ``csrc/pixel_lm.cu`` does not take: a profile other
    than 'gauss' (``NotImplementedError``: the TPU ran those in Pallas, the
    port has no kernel for them yet), a window rank other than 2 or 3, a
    parameter layout, slot or feature count outside the kernel's, and
    tensors of the wrong dtype, shape, device or layout."""
    if model is not get_model("gauss"):
        raise NotImplementedError(
            f"{who}: profile {model.name!r} has no CUDA kernel yet "
            "(ROADMAP queue 2 item 1: non-gauss profiles in "
            "csrc/lm_core.cuh)"
        )
    D = len(window_shape)
    if D not in (2, 3) or layout.ndim != D:
        raise ValueError(f"{who}: a {layout.ndim}D layout on window "
                         f"{tuple(window_shape)}")
    if tuple(layout.param_names) != tuple(
            param_names_for(model, D, layout.isotropic)):
        raise ValueError(f"{who}: unexpected parameter layout")
    B, V = vect0.shape
    n, P = layout.n_features, layout.n_params
    if not 0 < V <= _CUDA_MAX_SLOTS or V != layout.n_slots:
        raise ValueError(f"{who}: V={V} slots outside the kernel's "
                         f"1..{_CUDA_MAX_SLOTS}")
    if n > _CUDA_MAX_FEATURES:
        raise ValueError(f"{who}: n={n} features > {_CUDA_MAX_FEATURES}")
    device = vect0.device
    f32 = torch.float32
    check_tensor(who, "vect0", vect0, f32, (B, V), device)
    check_tensor(who, "const_params", const_params, f32, (B, n, P), device)
    if pixels is not None:
        check_tensor(who, "pixels", pixels, f32,
                     (B, int(np.prod(window_shape))), device)
    check_tensor(who, "pos_at", pos_at, f32, (B, n, D), device)
    check_tensor(who, "origin", origin, torch.int32, (B, D), device)
    check_tensor(who, "norm", norm, f32, (B,), device)
    check_tensor(who, "valid", valid, torch.bool, (B,), device)
    check_tensor(who, "fvalid", fvalid, f32, (B, n), device)


_ARGTYPES = (
    [ctypes.c_void_p] * 12          # pixels .. scratch
    + [ctypes.c_int] * 9            # B, n, P, V, iso, D, wz, wy, wx
    + [ctypes.c_float] * 3          # inv_rz, inv_ry, inv_rx
    + [ctypes.c_int] * 2            # streamed, max_iter
    + [ctypes.c_float] * 7          # ftol .. plateau
    + [ctypes.c_void_p] * 5         # outputs
    + [ctypes.c_void_p]             # stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("pixel_lm")
    if lib.pixel_lm_launch.argtypes is None:
        lib.pixel_lm_launch.argtypes = _ARGTYPES
        lib.pixel_lm_launch.restype = ctypes.c_int
        lib.pixel_lm_smem_words.argtypes = [ctypes.c_int] * 3
        lib.pixel_lm_smem_words.restype = ctypes.c_int
        lib.pixel_lm_occupancy.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.pixel_lm_occupancy.restype = ctypes.c_int
        for d in (2, 3):
            for streamed in (0, 1):
                if lib.pixel_lm_smem_words(d, 100, streamed) != smem_words(
                        d, 100, streamed):
                    raise RuntimeError("pixel_lm: smem_words disagrees with "
                                       "csrc/pixel_lm.cu")
    return lib


def occupancy(window_shape, device="cuda"):
    """Warps per SM of each mode of ``csrc/pixel_lm.cu`` for a window on a
    CUDA device, from the CUDA occupancy calculator: {'resident': w,
    'streamed': w}, 0 for a mode whose warp does not fit a block."""
    device = torch.device(device)
    lib = _library()
    out = {}
    with torch.cuda.device(device):
        for mode in ("resident", "streamed"):
            warps = ctypes.c_int(0)
            rc = lib.pixel_lm_occupancy(
                len(window_shape), int(np.prod(window_shape)),
                int(mode == "streamed"), ctypes.byref(warps))
            if rc != 0:
                raise RuntimeError(f"pixel_lm: occupancy query failed, "
                                   f"cudaError {rc}")
            out[mode] = warps.value
    return out


def _default_streaming(window_shape, device):
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), tuple(window_shape))
    if key not in _MODE_CHOICE:
        _MODE_CHOICE[key] = pick_streaming(occupancy(window_shape, device))
    return _MODE_CHOICE[key]


def pixel_lm(vect0, const_params, pixels, pos_at, origin, norm, valid,
             fvalid=None, *, model, layout, window_shape, lo, hi, radius,
             max_iter=60, ftol=1.49e-8, xtol=1.49e-8, lam0=1e-3, lam_up=4.0,
             lam_down=0.25, lam_max=1e10, streaming=None):
    """LM solve of one bucket on gathered pixels (see the module
    docstring).

    CUDA tensors launch ``csrc/pixel_lm.cu``, resident or streamed as
    ``streaming`` says (None: by occupancy); CPU tensors get
    ``pixel_lm_reference``.  Raises ``NotImplementedError`` on CUDA for a
    profile other than 'gauss', which the TPU ran in Pallas but this port
    has no kernel for yet."""
    kw = dict(model=model, layout=layout, window_shape=window_shape, lo=lo,
              hi=hi, radius=radius, max_iter=max_iter, ftol=ftol,
              xtol=xtol, lam0=lam0, lam_up=lam_up, lam_down=lam_down,
              lam_max=lam_max)
    device = pixels.device
    if device.type == "cpu":
        return pixel_lm_reference(vect0, const_params, pixels, pos_at,
                                  origin, norm, valid, fvalid, **kw)
    if device.type != "cuda":
        raise ValueError(f"pixel_lm: unsupported device {device}")
    B, V = vect0.shape
    n, P = layout.n_features, layout.n_params
    if fvalid is None:
        fvalid = torch.ones((B, n), dtype=torch.float32, device=device)
    check_pixel_lm_args(vect0, const_params, pixels, pos_at, origin, norm,
                        valid, fvalid, model=model, layout=layout,
                        window_shape=window_shape)
    D = len(window_shape)
    wz, wy, wx = (1,) + tuple(window_shape) if D == 2 else window_shape
    f32, i32 = torch.float32, torch.int32
    lib = _library()
    if streaming is None:
        streaming = _default_streaming(window_shape, device)
    streaming = bool(streaming)
    scratch = (torch.empty((B, wz * wy * wx), dtype=i32, device=device)
               if streaming else None)
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
    inv_r = [1.0] * (3 - D) + inv_r
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pixel_lm_launch(
            pixels.data_ptr(), origin.data_ptr(), vect0.data_ptr(),
            const_params.data_ptr(), pos_at.data_ptr(), norm.data_ptr(),
            valid_i.data_ptr(), fvalid.data_ptr(), slot_idx.data_ptr(),
            lo_t.data_ptr(), hi_t.data_ptr(),
            scratch.data_ptr() if streaming else None,
            B, n, P, V, int(layout.isotropic), D, wz, wy, wx,
            inv_r[0], inv_r[1], inv_r[2], int(streaming), int(max_iter),
            float(ftol), float(xtol), float(lam0), float(lam_up),
            float(lam_down), float(lam_max), float(1e6 * lam0),
            x_out.data_ptr(), cost.data_ptr(), n_iter.data_ptr(),
            conv.data_ptr(), npix.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"pixel_lm: kernel launch failed, cudaError {rc}")
    if streaming:
        pixel_lm.launches_streamed += 1
    else:
        pixel_lm.launches_resident += 1
    return LMResult(x=x_out, cost=cost, n_iter=n_iter,
                    converged=conv.to(torch.bool), npix=npix)


pixel_lm.launches_resident = 0
pixel_lm.launches_streamed = 0
