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
  ``pixel_lm.launches_resident`` or ``pixel_lm.launches_streamed``, and in
  ``pixel_lm.launches_mma`` where its sums ran on the FP64 tensor cores
  (``sum_path``); on CPU tensors it returns the plain version's result.
  It raises on anything the kernel does not take, and never swaps in the
  plain version for a CUDA tensor.
- ``pixel_lm_reference`` is the plain PyTorch version: ``kernel_mask`` and
  ``ops/lm.py::lm_solve`` on the model of ``ops/residual.py`` (a rigid
  bucket: on the chain-rule model of ``ops/rigid.py``, full vector).
- ``kernel_mask`` is the fit mask every LM kernel of the port builds.
- ``profile_tag`` names the built-in profile a kernel evaluates
  (``csrc/lm_core.cuh``), None for a custom model, which no kernel runs.
- ``SlotBounds`` is the form every LM wrapper of the port takes a bucket's
  bounds in: device tensors of the whole vector, and the configuration's
  kernel layout built from them on the first launch and kept.
- ``KernelProblem`` prepares a launch's own arguments: for a rigid
  ``constraint`` the compact vector [pose, non-position slots]
  (``ops/rigid.py::rigid_kernel_slots``) and its expansion back.

Modes (``streaming``): resident keeps each warp's in-mask voxels and their
values in shared memory; streamed keeps the voxel list in a global scratch
and reads values from ``pixels`` on every sweep.  ``streaming=None`` picks
by occupancy: resident unless its shared memory holds fewer warps per SM
than streamed, whose warps are bound by registers (CUDA's occupancy
calculator, per device, window and instantiation).  Both modes give the
same results bit for bit.  On an H100, config 4's 9×13×13 window (V = 14,
sums on the FP64 tensor cores) holds 10 warps per SM resident (its 20.7 KB
of shared memory a warp) against 20 streamed, so it streams; config 3c's
16³ window holds 5 resident against 12 streamed, so it streams (3.11 ms
against 4.36 ms per launch at B=2,048, NVIDIA H100 80GB HBM3, 700 W).

Both versions take the reference ``solve``'s arguments::

    vect0 [B, V] f32, const_params [B, n, P] f32, pixels [B, Npix] f32,
    pos_at [B, n, D] f32 (gather-time positions), origin [B, D] i32,
    norm [B] f32, valid [B] bool, fvalid [B, n] f32 or None

and ``bounds`` (a ``SlotBounds``; a rigid ``constraint``: vect0 [B, Qt + V]
over refine.py's rigid layout, the bounds alike) and return
``LMResult(x, cost, n_iter, converged, npix)``.  Lanes with ``valid``
False are not solved: x is the clipped ``vect0`` and cost, n_iter,
converged and npix are 0.
"""
from __future__ import annotations

import ctypes
import functools
import types

import numpy as np
import torch

from ..constraints import base_vertices, circumradius_factor
from ..models.packing import param_names_for
from ..models.registry import MODELS
from .lm import LMResult, lm_solve
from .residual import make_model_fns, window_offsets
from .rigid import make_constrained_fns, rigid_kernel_slots, rigid_supported
from .window_gather import check_tensor

__all__ = ["KernelProblem", "SlotBounds", "check_pixel_lm_args",
           "kernel_mask", "launch_mode", "occupancy", "pixel_lm",
           "pixel_lm_reference", "pick_streaming", "pose_kind", "profile_tag",
           "smem_words", "sum_path"]

# Caps of csrc/lm_core.cuh (kMaxSlots, kMaxFeatures, kMaxSeries).
_CUDA_MAX_SLOTS = 20
_CUDA_MAX_FEATURES = 32
_CUDA_MAX_SERIES = 8
_J_TILE_WORDS = 1152     # kJTileWords: the J tile, NPX pixels per lane
# kRegSlotsMid, kRegSlotsHigh: a gauss launch with MID < V <= HIGH slots
# takes the high ceiling's instantiation, whose sums run on the FP64
# tensor cores (pixel_lm.cu's Sums, which static_asserts these values)
_REG_SLOTS_MID, _REG_SLOTS_HIGH = 10, 14
# lm_core.cuh's Profile and PoseKind tags
_PROFILE_TAGS = {"gauss": 0, "ring": 1, "hat": 2, "disc": 3}
_INV_SERIES_TAG = 4
POSE_NONE, POSE_NGON_2D, POSE_AXIS_3D, POSE_ROTVEC_3D = 0, 1, 2, 3
# (device index, window shape, profile, pose, slot count) ->
# streaming=None's choice; the slot count picks the instantiation
# (lm_core.cuh's slot-count ceilings), whose registers set the warps per SM
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
                       bounds, radius, max_iter=60, ftol=1.49e-8,
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
        lam_down=lam_down, lam_max=lam_max, lower=bounds.lo,
        upper=bounds.hi, valid=valid,
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
    core = (_J_TILE_WORDS
            + (_CUDA_MAX_SLOTS + 1) * (_CUDA_MAX_SLOTS + 2)
            + 2 * _CUDA_MAX_SLOTS
            + _CUDA_MAX_FEATURES * feat_f + 1 + _CUDA_MAX_FEATURES * feat_i
            + _pose_words(pose))
    return core + (0 if streamed else 2 * int(npix))


def _mma_sums(profile, n_slots):
    """Whether a launch of ``profile`` with ``n_slots`` kernel slots sums
    on the FP64 tensor cores: the gauss profile's high ceiling."""
    return profile == 0 and _REG_SLOTS_MID < n_slots <= _REG_SLOTS_HIGH


def _kernel_slots(layout, constraint):
    """The slots the kernel solves: a rigid bucket's compact vector."""
    return (layout.n_slots if constraint is None
            else len(rigid_kernel_slots(layout, constraint)[1]))


def sum_path(model, layout, constraint=None):
    """How ``csrc/pixel_lm.cu`` forms a bucket's sums: 'f64_mma' (FP64
    tensor-core MMAs, each item rounded to float32 once; gauss buckets of
    11 to 14 kernel slots, 2D and 3D, free or rigid) or 'fp32_regs'
    (float32 sums per lane, then across the warp)."""
    return ("f64_mma" if _mma_sums(profile_tag(model),
                                   _kernel_slots(layout, constraint))
            else "fp32_regs")


def pick_streaming(warps):
    """``streaming=None``'s choice from ``occupancy``'s warps per SM: stream
    when resident holds fewer warps per SM (0: it does not fit at all)."""
    return warps["resident"] < warps["streamed"]


class SlotBounds:
    """A bucket configuration's slot bounds on one device: the form in which
    every LM wrapper of the port, and its plain version, takes them.

    ``lo`` / ``hi`` [V] f32 on ``device`` bound the whole solve vector (a
    rigid ``constraint``: refine.py's rigid layout, [Qt + V]).  A kernel's
    first launch builds the configuration's kernel layout from them
    (``kernel``, ``tied``) and keeps it, so a caller that keeps its
    ``SlotBounds``, as the bucket solver does per frame shape, copies no
    constant to the device after that.  Every copy is made before a
    launch: a pageable copy waits for the stream, and after the launch it
    would hold the host until the kernel ends.  Built for one ``layout``
    and ``constraint``; the kernel wrappers refuse it for others."""

    def __init__(self, layout, constraint, lo, hi, device="cpu"):
        self.layout, self.constraint = layout, constraint
        self.device = torch.device(device)
        self.lo = torch.as_tensor(lo, dtype=torch.float32,
                                  device=self.device)
        self.hi = torch.as_tensor(hi, dtype=torch.float32,
                                  device=self.device)
        self._tied = {}

    def to(self, device):
        """These bounds on ``device`` (its kernel layout built anew)."""
        return SlotBounds(self.layout, self.constraint, self.lo, self.hi,
                          device)

    @functools.cached_property
    def kernel(self):
        """The kernel layout: ``slot_idx`` [n, P] i32 and ``lo`` / ``hi``
        [Vk] (a rigid bucket's compact vector [pose, non-position slots],
        ``ops/rigid.py::rigid_kernel_slots``), the rigid vector's ``keep``
        and inert ``drop`` columns (else None) and the pose's ``pose``,
        ``fit_dist``, ``circ``, ``rc_fixed`` and ``base``."""
        layout, constraint, device = self.layout, self.constraint, self.device
        k = types.SimpleNamespace(
            pose=pose_kind(layout, constraint), lo=self.lo, hi=self.hi,
            keep=None, drop=None, fit_dist=0, circ=0, rc_fixed=0, base=None)
        slot_idx = np.asarray(layout.slot_idx, np.int32)
        if constraint is not None:
            _, keep, drop, remap = rigid_kernel_slots(layout, constraint)
            slot_idx = np.where(slot_idx >= 0,
                                remap[np.maximum(slot_idx, 0)], -1)
            k.keep = torch.as_tensor(keep, device=device)
            k.drop = torch.as_tensor(drop, device=device)
            k.lo, k.hi = self.lo[k.keep], self.hi[k.keep]
            k.fit_dist = int(constraint.fit_dist)
            n, D = layout.n_features, layout.ndim
            k.circ = float(circumradius_factor(n, D))
            if not constraint.fit_dist:
                k.rc_fixed = float(k.circ * float(constraint.dist))
            if k.pose == POSE_NGON_2D:
                base = 2.0 * np.pi * np.arange(n) / n
            elif k.pose == POSE_ROTVEC_3D:
                base = base_vertices(n, 3)
            else:
                base = np.zeros(1)
            k.base = torch.as_tensor(
                np.ascontiguousarray(base, np.float32), device=device)
        k.slot_idx = torch.as_tensor(slot_idx, dtype=torch.int32,
                                     device=device)
        return k

    def tied(self, global_slots):
        """The kernel slots of ``global_slots`` ([V] bool over the whole
        vector), ascending, [G] i32 on the device, built once a mask: a
        rigid bucket's compact vector keeps a tied distance at Qt − 1."""
        mask = np.asarray(global_slots, bool)
        key = mask.tobytes()
        if key not in self._tied:
            if self.constraint is not None:
                mask = mask[rigid_kernel_slots(self.layout,
                                               self.constraint)[1]]
            self._tied[key] = torch.as_tensor(
                np.flatnonzero(mask).astype(np.int32), device=self.device)
        return self._tied[key]

    def check(self, who, layout, constraint, V, device):
        """Raise unless these are the bounds of ``layout`` and
        ``constraint``, [V] f32 on ``device``."""
        if self.layout is not layout or self.constraint is not constraint:
            raise ValueError(f"{who}: bounds of another configuration")
        for name, t in (("lo", self.lo), ("hi", self.hi)):
            check_tensor(who, name, t, torch.float32, (V,), device)


class KernelProblem:
    """A launch's own arguments: ``x0`` [B, Vk] (compact for a rigid
    bucket) and the rigid pose's ``xn``; ``expand(xk)`` gives the full
    vector back, the inert position slots at their clipped start.  The
    configuration's constants are ``bounds.kernel``'s."""

    def __init__(self, vect0, model, bounds):
        self.profile = profile_tag(model)
        self.nx = len(model.extra_params)
        self.kernel = k = bounds.kernel
        self.xn = None
        if k.keep is not None:
            # the full vector at its clipped start; the kernel's result
            # lands in its kept columns (expand)
            self._full = torch.clamp(vect0, bounds.lo, bounds.hi)
            self.xn = torch.amax(torch.abs(self._full[:, k.drop]),
                                 dim=1).contiguous()
            vect0 = vect0[:, k.keep]
        self.x0 = vect0.contiguous()

    def args(self):
        """The launch's (prof, nx, pose, fit_dist, circ, rc_fixed, base,
        xn) arguments."""
        k = self.kernel
        ptr = (lambda t: None if t is None else t.data_ptr())
        return (self.profile, self.nx, k.pose, k.fit_dist, k.circ,
                k.rc_fixed, ptr(k.base), ptr(self.xn))

    def expand(self, xk):
        if self.kernel.keep is None:
            return xk
        self._full[:, self.kernel.keep] = xk
        return self._full


def check_pixel_lm_args(vect0, const_params, pixels, pos_at, origin, norm,
                        valid, fvalid, *, model, layout, window_shape,
                        bounds, who="pixel_lm", constraint=None):
    """Raise on anything ``csrc/pixel_lm.cu`` does not take: a model with no
    kernel profile (``NotImplementedError``: a custom model is a Python
    callable; ``kernel_route`` sends such buckets to ``lm_solve``), a
    constraint the rigid kernels do not inline, a window rank other than 2
    or 3, a parameter layout, slot or feature count outside the kernel's,
    bounds built for another configuration or device, and tensors of the
    wrong dtype, shape, device or layout."""
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
    if pos_at is not None:   # None: fused_lm_2d's refit loop
        check_tensor(who, "pos_at", pos_at, f32, (B, n, D), device)
    if origin is not None:
        check_tensor(who, "origin", origin, torch.int32, (B, D), device)
    check_tensor(who, "norm", norm, f32, (B,), device)
    check_tensor(who, "valid", valid, torch.bool, (B,), device)
    check_tensor(who, "fvalid", fvalid, f32, (B, n), device)
    bounds.check(who, layout, constraint, V, device)


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
        lib.pixel_lm_occupancy.argtypes = [ctypes.c_int] * 6 + [
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


def occupancy(window_shape, device="cuda", profile=0, pose=POSE_NONE,
              n_slots=_CUDA_MAX_SLOTS):
    """Warps per SM of each mode of ``csrc/pixel_lm.cu`` for a window (and
    a profile tag, pose kind and slot count, which pick the instantiation)
    on a CUDA device, from the CUDA occupancy calculator: {'resident': w,
    'streamed': w}, 0 for a mode whose warp does not fit a block."""
    device = torch.device(device)
    lib = _library()
    out = {}
    with torch.cuda.device(device):
        for mode in ("resident", "streamed"):
            warps = ctypes.c_int(0)
            rc = lib.pixel_lm_occupancy(
                len(window_shape), int(np.prod(window_shape)),
                int(mode == "streamed"), profile, pose, int(n_slots),
                ctypes.byref(warps))
            if rc != 0:
                raise RuntimeError(f"pixel_lm: occupancy query failed, "
                                   f"cudaError {rc}")
            out[mode] = warps.value
    return out


def launch_mode(model, layout, constraint, window_shape, device,
                streaming=None):
    """'resident' or 'streamed': the mode ``pixel_lm`` launches for a
    bucket on the CUDA ``device``, as ``streaming`` forces it or, for
    None, as occupancy picks it."""
    if streaming is None:
        device = torch.device(device)
        key = (device.index if device.index is not None
               else torch.cuda.current_device(), tuple(window_shape),
               profile_tag(model), pose_kind(layout, constraint),
               _kernel_slots(layout, constraint))
        if key not in _MODE_CHOICE:
            _MODE_CHOICE[key] = pick_streaming(
                occupancy(window_shape, device, *key[2:]))
        streaming = _MODE_CHOICE[key]
    return "streamed" if streaming else "resident"


def pixel_lm(vect0, const_params, pixels, pos_at, origin, norm, valid,
             fvalid=None, *, model, layout, window_shape, bounds, radius,
             max_iter=60, ftol=1.49e-8, xtol=1.49e-8, lam0=1e-3, lam_up=4.0,
             lam_down=0.25, lam_max=1e10, streaming=None, constraint=None):
    """LM solve of one bucket on gathered pixels (see the module
    docstring).

    CUDA tensors launch ``csrc/pixel_lm.cu``, resident or streamed as
    ``streaming`` says (None: by occupancy), with the model's profile and,
    for a rigid 3D ``constraint``, its pose inlined; CPU tensors get
    ``pixel_lm_reference``.  Raises ``NotImplementedError`` on CUDA for a
    custom model, which no kernel evaluates."""
    kw = dict(model=model, layout=layout, window_shape=window_shape,
              bounds=bounds, radius=radius, max_iter=max_iter, ftol=ftol,
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
                        window_shape=window_shape, bounds=bounds,
                        constraint=constraint)
    D = len(window_shape)
    if constraint is not None and D != 3:
        raise ValueError("pixel_lm: a rigid 2D bucket takes fused_lm_2d "
                         "(kernel_route)")
    wz, wy, wx = (1,) + tuple(window_shape) if D == 2 else window_shape
    f32, i32 = torch.float32, torch.int32
    lib = _library()
    kp = KernelProblem(vect0, model, bounds)
    Vk = kp.x0.shape[1]
    if streaming is None:
        streaming = launch_mode(model, layout, constraint, window_shape,
                                device) == "streamed"
    scratch = (torch.empty((B, wz * wy * wx), dtype=i32, device=device)
               if streaming else None)
    valid_i = valid.to(i32)
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
            valid_i.data_ptr(), fvalid.data_ptr(),
            kp.kernel.slot_idx.data_ptr(),
            kp.kernel.lo.data_ptr(), kp.kernel.hi.data_ptr(),
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
    if _mma_sums(kp.profile, Vk):
        pixel_lm.launches_mma += 1
    return LMResult(x=kp.expand(x_out), cost=cost, n_iter=n_iter,
                    converged=conv.to(torch.bool), npix=npix)


pixel_lm.launches_resident = 0
pixel_lm.launches_streamed = 0
pixel_lm.launches_mma = 0
