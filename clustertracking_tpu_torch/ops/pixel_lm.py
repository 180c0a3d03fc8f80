"""LM solve of one bucket on windows gathered beforehand: the CUDA kernel,
its plain version, the kernel's fit mask and what every LM kernel of the
port shares (profile tags, rigid launch arguments).

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
  ``ops/lm.py::lm_solve`` on the model of ``ops/residual.py`` (a rigid
  bucket: on the chain-rule model of ``ops/rigid.py``, full vector).
- ``kernel_mask`` is the fit mask every LM kernel of the port builds.
- ``profile_tag`` names the built-in profile a kernel evaluates
  (``csrc/lm_core.cuh``), None for a custom model, which no kernel runs.
- ``KernelProblem`` prepares a launch's model and pose arguments: for a
  rigid ``constraint`` the compact vector [pose, non-position slots]
  (``ops/rigid.py::rigid_kernel_slots``) and its expansion back.

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

(a rigid ``constraint``: vect0 [B, Qt + V] over refine.py's rigid layout,
lo/hi alike) and return ``LMResult(x, cost, n_iter, converged, npix)``.
Lanes with ``valid`` False are not solved: x is the clipped ``vect0`` and
cost, n_iter, converged and npix are 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constraints import base_vertices, circumradius_factor
from ..models.packing import param_names_for
from ..models.registry import MODELS
from .lm import LMResult, lm_solve
from .residual import make_model_fns, window_offsets
from .rigid import make_constrained_fns, rigid_kernel_slots, rigid_supported
from .window_gather import check_tensor

__all__ = ["KernelProblem", "check_pixel_lm_args", "kernel_mask",
           "occupancy", "pixel_lm", "pixel_lm_reference", "pick_streaming",
           "pose_kind", "profile_tag", "smem_words"]

# Caps of csrc/lm_core.cuh (kMaxSlots, kMaxFeatures, kMaxSeries).
_CUDA_MAX_SLOTS = 20
_CUDA_MAX_FEATURES = 32
_CUDA_MAX_SERIES = 8
# lm_core.cuh's Profile and PoseKind tags
_PROFILE_TAGS = {"gauss": 0, "ring": 1, "hat": 2, "disc": 3}
_INV_SERIES_TAG = 4
POSE_NONE, POSE_NGON_2D, POSE_AXIS_3D, POSE_ROTVEC_3D = 0, 1, 2, 3
# (device index, window shape, profile, pose) -> streaming=None's choice
_MODE_CHOICE = {}


def profile_tag(model):
    """``csrc/lm_core.cuh``'s tag of a built-in profile, or None: a custom
    model (a dict or a ``ModelSpec`` not in the registry) is a Python
    callable no CUDA kernel can run, and inv_series beyond
    ``_CUDA_MAX_SERIES`` coefficients is past the kernel's staging."""
    if MODELS.get(model.name) is not model:
        return None
    if model.name in _PROFILE_TAGS:
        return _PROFILE_TAGS[model.name]
    if model.name.startswith("inv_series_") and \
            len(model.extra_params) <= _CUDA_MAX_SERIES:
        return _INV_SERIES_TAG
    return None


def _staged_extras(tag):
    """Extra parameters per feature a profile's instantiation stages."""
    return {0: 0, 1: 1, 2: 1, 3: 0, _INV_SERIES_TAG: _CUDA_MAX_SERIES}[tag]


def pose_kind(layout, constraint):
    """``csrc/lm_core.cuh``'s pose kind of a (rigid) bucket."""
    if constraint is None:
        return POSE_NONE
    if layout.ndim == 2:
        return POSE_NGON_2D
    return POSE_AXIS_3D if layout.n_features == 2 else POSE_ROTVEC_3D


def _pose_words(pose):
    return {POSE_NONE: 0, POSE_NGON_2D: 1 + 2 * _CUDA_MAX_FEATURES,
            POSE_AXIS_3D: 10,
            POSE_ROTVEC_3D: 1 + 12 * _CUDA_MAX_FEATURES}[pose]


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
                       lam_max=1e10, constraint=None):
    """Plain PyTorch version of ``pixel_lm``: kernel mask, ``lm_solve``.
    Works for any profile and window rank, on any device.  With a
    ``constraint`` it solves the full constrained vector with
    ``ops/rigid.py``'s Jacobian (rigid: the chain rule, inert position
    columns), as the reference's XLA path does."""
    device = pixels.device
    B, n = vect0.shape[0], layout.n_features
    if fvalid is None:
        fvalid = torch.ones((B, n), dtype=torch.float32, device=device)
    if constraint is None:
        fns = make_model_fns(model, layout, tuple(window_shape),
                             device=device)
        extra = (fvalid,)
    else:
        fns = make_constrained_fns(model, layout, tuple(window_shape),
                                   constraint, device=device)
        extra = ()
    mask = kernel_mask(pos_at, origin, window_shape, radius, fvalid)
    res = lm_solve(
        fns.residual, fns.residual_jac, vect0,
        (const_params, pixels, mask, origin, norm) + extra,
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


def smem_words(ndim, npix, streamed, profile=0, pose=POSE_NONE):
    """Per-warp shared memory of ``csrc/pixel_lm.cu`` in a mode, in 4-byte
    words (``pixel_lm_smem_words``): the LM core of ``lm_core.cuh`` (a
    profile's extras and a pose's constants add to it) plus, resident,
    the voxel list and its values."""
    nx = _staged_extras(profile)
    feat_f, feat_i = 2 + 2 * ndim + nx, 1 + 2 * ndim + nx
    core = (32 * (_CUDA_MAX_SLOTS + 1)
            + 2 * (1 + _CUDA_MAX_SLOTS
                   + _CUDA_MAX_SLOTS * (_CUDA_MAX_SLOTS + 1) // 2)
            + 3 * _CUDA_MAX_SLOTS
            + _CUDA_MAX_FEATURES * feat_f + 1 + _CUDA_MAX_FEATURES * feat_i
            + _CUDA_MAX_SLOTS * _CUDA_MAX_SLOTS + _pose_words(pose))
    return core + (0 if streamed else 2 * int(npix))


def pick_streaming(warps):
    """``streaming=None``'s choice from ``occupancy``'s warps per SM: stream
    when resident holds fewer warps per SM (0: it does not fit at all)."""
    return warps["resident"] < warps["streamed"]


class KernelProblem:
    """A launch's model and pose arguments.

    x0 [B, Vk], lo/hi [Vk] and slot_idx [n, P] are the kernel's (compact
    for a rigid bucket); ``expand(xk)`` gives the full vector back, the
    inert position slots at their clipped start.  Every host→device copy
    is made here, before the launch: a pageable copy waits for the
    stream, and after the launch it would hold the host until the kernel
    ends."""

    def __init__(self, vect0, layout, model, constraint, lo, hi, device):
        self.profile = profile_tag(model)
        self.nx = len(model.extra_params)
        self.pose = pose_kind(layout, constraint)
        self.fit_dist = self.circ = self.rc_fixed = 0
        self.base = self.xn = None
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        slot_idx = np.asarray(layout.slot_idx, np.int32)
        self.keep = None
        if constraint is not None:
            Qt, keep, drop, remap = rigid_kernel_slots(layout, constraint)
            self.keep = torch.as_tensor(keep, device=device)
            slot_idx = np.where(slot_idx >= 0,
                                remap[np.maximum(slot_idx, 0)], -1)
            # the full vector at its clipped start; the kernel's result
            # lands in its kept columns (expand)
            self._full = torch.clamp(
                vect0, torch.as_tensor(lo, device=device),
                torch.as_tensor(hi, device=device))
            lo, hi = lo[keep], hi[keep]
            self.xn = torch.amax(torch.abs(self._full[:, drop]),
                                 dim=1).contiguous()
            self.fit_dist = int(constraint.fit_dist)
            n, D = layout.n_features, layout.ndim
            self.circ = float(circumradius_factor(n, D))
            if not constraint.fit_dist:
                self.rc_fixed = float(self.circ * float(constraint.dist))
            if self.pose == POSE_NGON_2D:
                base = 2.0 * np.pi * np.arange(n) / n
            elif self.pose == POSE_ROTVEC_3D:
                base = base_vertices(n, 3)
            else:
                base = np.zeros(1)
            self.base = torch.as_tensor(
                np.ascontiguousarray(base, np.float32), device=device)
            vect0 = vect0[:, self.keep]
        self.x0 = vect0.contiguous()
        self.slot_idx = torch.as_tensor(slot_idx, dtype=torch.int32,
                                        device=device)
        self.lo = torch.as_tensor(lo, device=device)
        self.hi = torch.as_tensor(hi, device=device)

    def args(self):
        """The launch's (prof, nx, pose, fit_dist, circ, rc_fixed, base,
        xn) arguments."""
        ptr = (lambda t: None if t is None else t.data_ptr())
        return (self.profile, self.nx, self.pose, self.fit_dist,
                self.circ, self.rc_fixed, ptr(self.base), ptr(self.xn))

    def expand(self, xk):
        if self.keep is None:
            return xk
        self._full[:, self.keep] = xk
        return self._full


def check_pixel_lm_args(vect0, const_params, pixels, pos_at, origin, norm,
                        valid, fvalid, *, model, layout, window_shape,
                        who="pixel_lm", constraint=None):
    """Raise on anything ``csrc/pixel_lm.cu`` does not take: a model with no
    kernel profile (``NotImplementedError``: a custom model is a Python
    callable; ``kernel_route`` sends such buckets to ``lm_solve``), a
    constraint the rigid kernels do not inline, a window rank other than 2
    or 3, a parameter layout, slot or feature count outside the kernel's,
    and tensors of the wrong dtype, shape, device or layout."""
    if profile_tag(model) is None:
        raise NotImplementedError(
            f"{who}: model {model.name!r} is not a built-in profile; no CUDA "
            "kernel evaluates a custom model (kernel_route takes lm_solve, "
            "ROADMAP queue 2 item 1)"
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
    Vk = layout.n_slots
    if constraint is not None:
        if not rigid_supported(layout, constraint):
            raise ValueError(f"{who}: no rigid kernel for constraint "
                             f"{constraint.name!r} on this layout")
        Qt, keep, _, _ = rigid_kernel_slots(layout, constraint)
        Vk = len(keep)
        if V != Qt + layout.n_slots:
            raise ValueError(f"{who}: vect0 has {V} columns, the rigid "
                             f"layout {Qt + layout.n_slots}")
    elif V != layout.n_slots:
        raise ValueError(f"{who}: vect0 has {V} columns, the layout "
                         f"{layout.n_slots}")
    if not 0 < Vk <= _CUDA_MAX_SLOTS:
        raise ValueError(f"{who}: {Vk} kernel slots outside the kernel's "
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


# (prof, nx, pose, fit_dist, circ, rc_fixed, base, xn): lm_core.cuh's
# model arguments, in both kernels' launch signatures
MODEL_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_float] * 2
                  + [ctypes.c_void_p] * 2)

_ARGTYPES = (
    [ctypes.c_void_p] * 12          # pixels .. scratch
    + [ctypes.c_int] * 9            # B, n, P, V, iso, D, wz, wy, wx
    + [ctypes.c_float] * 3          # inv_rz, inv_ry, inv_rx
    + [ctypes.c_int] * 2            # streamed, max_iter
    + [ctypes.c_float] * 7          # ftol .. plateau
    + MODEL_ARGTYPES                # prof .. xn
    + [ctypes.c_void_p] * 5         # outputs
    + [ctypes.c_void_p]             # stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("pixel_lm")
    if lib.pixel_lm_launch.argtypes is None:
        lib.pixel_lm_launch.argtypes = _ARGTYPES
        lib.pixel_lm_launch.restype = ctypes.c_int
        lib.pixel_lm_smem_words.argtypes = [ctypes.c_int] * 5
        lib.pixel_lm_smem_words.restype = ctypes.c_int
        lib.pixel_lm_occupancy.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.pixel_lm_occupancy.restype = ctypes.c_int
        for d, pose in ((2, POSE_NONE), (3, POSE_NONE), (3, POSE_AXIS_3D),
                        (3, POSE_ROTVEC_3D)):
            for prof in (0, 1, _INV_SERIES_TAG):
                for streamed in (0, 1):
                    if lib.pixel_lm_smem_words(d, 100, streamed, prof,
                                               pose) != smem_words(
                            d, 100, streamed, prof, pose):
                        raise RuntimeError("pixel_lm: smem_words disagrees "
                                           "with csrc/pixel_lm.cu")
    return lib


def occupancy(window_shape, device="cuda", profile=0, pose=POSE_NONE):
    """Warps per SM of each mode of ``csrc/pixel_lm.cu`` for a window (and
    a profile tag and pose kind) on a CUDA device, from the CUDA occupancy
    calculator: {'resident': w, 'streamed': w}, 0 for a mode whose warp
    does not fit a block."""
    device = torch.device(device)
    lib = _library()
    out = {}
    with torch.cuda.device(device):
        for mode in ("resident", "streamed"):
            warps = ctypes.c_int(0)
            rc = lib.pixel_lm_occupancy(
                len(window_shape), int(np.prod(window_shape)),
                int(mode == "streamed"), profile, pose, ctypes.byref(warps))
            if rc != 0:
                raise RuntimeError(f"pixel_lm: occupancy query failed, "
                                   f"cudaError {rc}")
            out[mode] = warps.value
    return out


def _default_streaming(window_shape, device, profile, pose):
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), tuple(window_shape), profile,
           pose)
    if key not in _MODE_CHOICE:
        _MODE_CHOICE[key] = pick_streaming(
            occupancy(window_shape, device, profile, pose))
    return _MODE_CHOICE[key]


def pixel_lm(vect0, const_params, pixels, pos_at, origin, norm, valid,
             fvalid=None, *, model, layout, window_shape, lo, hi, radius,
             max_iter=60, ftol=1.49e-8, xtol=1.49e-8, lam0=1e-3, lam_up=4.0,
             lam_down=0.25, lam_max=1e10, streaming=None, constraint=None):
    """LM solve of one bucket on gathered pixels (see the module
    docstring).

    CUDA tensors launch ``csrc/pixel_lm.cu``, resident or streamed as
    ``streaming`` says (None: by occupancy), with the model's profile and,
    for a rigid 3D ``constraint``, its pose inlined; CPU tensors get
    ``pixel_lm_reference``.  Raises ``NotImplementedError`` on CUDA for a
    custom model, which no kernel evaluates."""
    kw = dict(model=model, layout=layout, window_shape=window_shape, lo=lo,
              hi=hi, radius=radius, max_iter=max_iter, ftol=ftol,
              xtol=xtol, lam0=lam0, lam_up=lam_up, lam_down=lam_down,
              lam_max=lam_max, constraint=constraint)
    device = pixels.device
    if device.type == "cpu":
        return pixel_lm_reference(vect0, const_params, pixels, pos_at,
                                  origin, norm, valid, fvalid, **kw)
    if device.type != "cuda":
        raise ValueError(f"pixel_lm: unsupported device {device}")
    B = vect0.shape[0]
    n, P = layout.n_features, layout.n_params
    if fvalid is None:
        fvalid = torch.ones((B, n), dtype=torch.float32, device=device)
    check_pixel_lm_args(vect0, const_params, pixels, pos_at, origin, norm,
                        valid, fvalid, model=model, layout=layout,
                        window_shape=window_shape, constraint=constraint)
    D = len(window_shape)
    if constraint is not None and D != 3:
        raise ValueError("pixel_lm: a rigid 2D bucket takes fused_lm_2d "
                         "(kernel_route)")
    wz, wy, wx = (1,) + tuple(window_shape) if D == 2 else window_shape
    f32, i32 = torch.float32, torch.int32
    lib = _library()
    kp = KernelProblem(vect0, layout, model, constraint, lo, hi, device)
    if streaming is None:
        streaming = _default_streaming(window_shape, device, kp.profile,
                                       kp.pose)
    streaming = bool(streaming)
    scratch = (torch.empty((B, wz * wy * wx), dtype=i32, device=device)
               if streaming else None)
    valid_i = valid.to(i32)
    Vk = kp.x0.shape[1]
    x_out = torch.empty((B, Vk), dtype=f32, device=device)
    cost = torch.empty((B,), dtype=f32, device=device)
    n_iter = torch.empty((B,), dtype=i32, device=device)
    conv = torch.empty((B,), dtype=i32, device=device)
    npix = torch.empty((B,), dtype=f32, device=device)
    inv_r = [float(np.float32(1.0 / float(r))) for r in radius]
    inv_r = [1.0] * (3 - D) + inv_r
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pixel_lm_launch(
            pixels.data_ptr(), origin.data_ptr(), kp.x0.data_ptr(),
            const_params.data_ptr(), pos_at.data_ptr(), norm.data_ptr(),
            valid_i.data_ptr(), fvalid.data_ptr(), kp.slot_idx.data_ptr(),
            kp.lo.data_ptr(), kp.hi.data_ptr(),
            scratch.data_ptr() if streaming else None,
            B, n, P, Vk, int(layout.isotropic), D, wz, wy, wx,
            inv_r[0], inv_r[1], inv_r[2], int(streaming), int(max_iter),
            float(ftol), float(xtol), float(lam0), float(lam_up),
            float(lam_down), float(lam_max), float(1e6 * lam0),
            *kp.args(),
            x_out.data_ptr(), cost.data_ptr(), n_iter.data_ptr(),
            conv.data_ptr(), npix.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"pixel_lm: kernel launch failed, cudaError {rc}")
    if streaming:
        pixel_lm.launches_streamed += 1
    else:
        pixel_lm.launches_resident += 1
    return LMResult(x=kp.expand(x_out), cost=cost, n_iter=n_iter,
                    converged=conv.to(torch.bool), npix=npix)


pixel_lm.launches_resident = 0
pixel_lm.launches_streamed = 0
