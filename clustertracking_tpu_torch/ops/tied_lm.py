"""The joint (tied) LM solve of one bucket: the CUDA kernel and its plain
version.

Counterpart of the reference's XLA route for buckets whose slots are tied
across lanes: ``clustertracking_tpu/refine.py:537`` calls
``ops/lm.py::lm_solve_global`` (:289) for 'global' parameter modes
(``train_leastsq``'s shared PSF coefficients) and for a rigid distance
shared by every cluster (``dimer_global()``).  No Pallas kernel exists
for it.  Here:

- ``tied_lm`` is the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/tied_lm.cu`` (built for sm_90a on first use;
  the whole joint loop in one cooperative launch, one warp per lane, every
  built-in profile, the rigid poses of ``csrc/lm_core.cuh`` with their
  fitted distance tied) and counts the launch in ``tied_lm.launches``; on
  CPU tensors it returns the plain version's result.  It raises on
  anything the kernel does not take, when the build or the launch fails,
  and when the card cannot hold the cooperative grid; it never swaps in
  the plain version for a CUDA tensor.
- ``tied_lm_reference`` is the plain PyTorch version: the call the bucket
  solver's plain route makes, ``ops/lm.py::lm_solve_global_shards`` on
  one ``GlobalShard`` with the bucket's ``make_model_fns`` (or, rigid,
  ``make_constrained_fns``) closures.
- ``tie_supported`` says whether the kernel takes a bucket's constraint
  once its distance is tied; ``pack_tied`` puts the tied-slot mask and
  the bounds into the kernel's (compact) layout.

Both take::

    vect0 [B, V] f32 (a rigid constraint: [B, Qt + V] over refine.py's
    rigid layout), const_params [B, n, P] f32, pixels [B, Npix] f32
    (``window_gather``), mask [B, Npix] f32 (``radius_mask``: 0 or 1),
    origin [B, D] i32, norm [B] f32, valid [B] bool, fvalid [B, n] f32 or
    None, global_slots [V] bool, lo / hi [V] f32 (numpy)

and return ``LMResult(x, cost, n_iter, converged, npix)`` as
``lm_solve_global`` defines them (npix: the mask's sum per lane).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..models.packing import param_names_for
from .lm import GlobalShard, LMResult, lm_solve_global_shards
from .pixel_lm import MODEL_ARGTYPES, KernelProblem, profile_tag
from .residual import make_model_fns
from .rigid import make_constrained_fns, rigid_kernel_slots, rigid_supported
from .window_gather import check_tensor

__all__ = ["TIED_MAX_SLOTS", "check_tied_lm_args", "max_blocks",
           "pack_tied", "tie_supported", "tied_lm", "tied_lm_reference"]

# Kernel slots a tied bucket may have: fewer than lm_core.cuh's kMaxSlots
# (a tied bucket of 20 slots or more takes lm_solve_global).
TIED_MAX_SLOTS = 20
_MAX_FEATURES = 32      # lm_core.cuh's kMaxFeatures


def tie_supported(layout, constraint) -> bool:
    """Whether ``csrc/tied_lm.cu`` takes a tied bucket's constraint: none,
    or a rigid one that the warp kernels inline once its distance is tied
    (``rigid_supported`` of the same constraint with a per-cluster
    distance) and whose inert position slots are not tied."""
    if constraint is None:
        return True
    if getattr(constraint, "kind", None) != "rigid":
        return False
    if not rigid_supported(layout,
                           dataclasses.replace(constraint,
                                               dist_mode="cluster")):
        return False
    Qt, _, drop, _ = rigid_kernel_slots(layout, constraint)
    return not np.any(np.asarray(layout.global_slots)[
        [d - Qt for d in drop]])


def pack_tied(layout, constraint, global_slots, lo, hi):
    """The tied slots and bounds in the kernel's layout: (tied [G] int32,
    the kernel slots of ``global_slots``, ascending; lo, hi [Vk] f32).  A
    rigid bucket's kernel vector is the compact [pose, non-position
    slots] (``rigid_kernel_slots``), so a tied distance at Qt − 1 stays
    at Qt − 1."""
    mask = np.asarray(global_slots, bool)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    if constraint is not None:
        keep = rigid_kernel_slots(layout, constraint)[1]
        mask, lo, hi = mask[keep], lo[keep], hi[keep]
    return np.flatnonzero(mask).astype(np.int32), lo, hi


def tied_lm_reference(vect0, const_params, pixels, mask, origin, norm,
                      valid, fvalid=None, *, model, layout, window_shape,
                      global_slots, lo, hi, max_iter=60, ftol=1.49e-8,
                      xtol=1.49e-8, lam0=1e-3, lam_up=4.0, lam_down=0.25,
                      lam_max=1e10, constraint=None):
    """Plain PyTorch version of ``tied_lm``: ``lm_solve_global_shards`` on
    one shard with the bucket's closures, as the bucket solver's plain
    route calls it.  Works for any model, constraint and window rank, on
    any device."""
    device = pixels.device
    if constraint is None:
        fns = make_model_fns(model, layout, tuple(window_shape),
                             device=device)
        extra = () if fvalid is None else (fvalid,)
    else:
        fns = make_constrained_fns(model, layout, tuple(window_shape),
                                   constraint, device=device)
        extra = ()
    shard = GlobalShard(
        fns.residual, fns.residual_jac, vect0,
        (const_params, pixels, mask, origin, norm) + extra,
        torch.as_tensor(np.asarray(lo, np.float32), device=device),
        torch.as_tensor(np.asarray(hi, np.float32), device=device), valid)
    res = lm_solve_global_shards(
        [shard], global_slots, max_iter=max_iter, ftol=ftol, xtol=xtol,
        lam0=lam0, lam_up=lam_up, lam_down=lam_down, lam_max=lam_max)[0]
    return res._replace(npix=mask.sum(dim=1))


def check_tied_lm_args(vect0, const_params, pixels, mask, origin, norm,
                       valid, fvalid, *, model, layout, window_shape,
                       global_slots, constraint=None):
    """Raise on anything ``csrc/tied_lm.cu`` does not take: a custom model
    (``NotImplementedError``: no kernel evaluates a Python callable), a
    window rank other than 2 or 3, a parameter layout other than the
    model's, a constraint other than a rigid one the kernel inlines, no
    tied slot, ``TIED_MAX_SLOTS`` kernel slots or more, more features than
    ``csrc/lm_core.cuh`` stages, and tensors of the wrong dtype, shape,
    device or layout."""
    who = "tied_lm"
    if profile_tag(model) is None:
        raise NotImplementedError(
            f"{who}: model {model.name!r} is not a built-in profile; no CUDA "
            "kernel evaluates a custom model (kernel_route takes "
            "lm_solve_global)")
    D = len(window_shape)
    if D not in (2, 3) or layout.ndim != D:
        raise ValueError(f"{who}: a {layout.ndim}D layout on window "
                         f"{tuple(window_shape)}")
    if tuple(layout.param_names) != tuple(
            param_names_for(model, D, layout.isotropic)):
        raise ValueError(f"{who}: unexpected parameter layout")
    if not tie_supported(layout, constraint):
        raise ValueError(f"{who}: no kernel for constraint "
                         f"{getattr(constraint, 'name', None)!r} on this "
                         "layout")
    B, V = vect0.shape
    n, P = layout.n_features, layout.n_params
    Vk = Vfull = layout.n_slots
    if constraint is not None:
        Qt, keep, _, _ = rigid_kernel_slots(layout, constraint)
        Vk, Vfull = len(keep), Qt + layout.n_slots
    if V != Vfull:
        raise ValueError(f"{who}: vect0 has {V} columns, the layout {Vfull}")
    if not 0 < Vk < TIED_MAX_SLOTS:
        raise ValueError(f"{who}: {Vk} kernel slots; the kernel takes 1 to "
                         f"{TIED_MAX_SLOTS - 1}")
    if n > _MAX_FEATURES:
        raise ValueError(f"{who}: n={n} features > {_MAX_FEATURES}")
    gs = np.asarray(global_slots, bool)
    if gs.shape != (V,) or not gs.any():
        raise ValueError(f"{who}: global_slots must be a [{V}] mask with a "
                         "tied slot")
    device = vect0.device
    f32 = torch.float32
    npix = int(np.prod(window_shape))
    check_tensor(who, "vect0", vect0, f32, (B, V), device)
    check_tensor(who, "const_params", const_params, f32, (B, n, P), device)
    check_tensor(who, "pixels", pixels, f32, (B, npix), device)
    check_tensor(who, "mask", mask, f32, (B, npix), device)
    check_tensor(who, "origin", origin, torch.int32, (B, D), device)
    check_tensor(who, "norm", norm, f32, (B,), device)
    check_tensor(who, "valid", valid, torch.bool, (B,), device)
    check_tensor(who, "fvalid", fvalid, f32, (B, n), device)


_ARGTYPES = (
    [ctypes.c_void_p] * 12          # pixels .. hi
    + [ctypes.c_void_p] * 10        # scratch: list .. part_max
    + [ctypes.c_int] * 10           # B, n, P, V, G, iso, D, wz, wy, wx
    + [ctypes.c_int]                # max_iter
    + [ctypes.c_float] * 7          # ftol .. plateau
    + MODEL_ARGTYPES                # prof .. xn
    + [ctypes.c_void_p] * 5         # outputs, iterations
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]   # grid_out, stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("tied_lm")
    if lib.tied_lm_launch.argtypes is None:
        lib.tied_lm_launch.argtypes = _ARGTYPES
        lib.tied_lm_launch.restype = ctypes.c_int
        lib.tied_lm_max_blocks.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.tied_lm_max_blocks.restype = ctypes.c_int
    return lib


def max_blocks(ndim, profile, pose, device="cuda"):
    """Blocks of ``csrc/tied_lm.cu`` (4 warps each, its kWarps) a CUDA
    device holds at once for an instantiation: the largest grid a launch
    takes."""
    lib = _library()
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        rc = lib.tied_lm_max_blocks(ndim, profile, pose, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"tied_lm: occupancy query failed, cudaError {rc}")
    return out.value


def tied_lm(vect0, const_params, pixels, mask, origin, norm, valid,
            fvalid=None, *, model, layout, window_shape, global_slots, lo,
            hi, max_iter=60, ftol=1.49e-8, xtol=1.49e-8, lam0=1e-3,
            lam_up=4.0, lam_down=0.25, lam_max=1e10, constraint=None):
    """The joint LM solve of one bucket (see the module docstring).

    CUDA tensors launch ``csrc/tied_lm.cu``, one cooperative launch for
    the whole loop (its grid in ``tied_lm.last_grid``, the joint loop's
    iterations in the device tensor ``tied_lm.last_iterations``, for
    measurement); CPU tensors get
    ``tied_lm_reference``.  Raises ``ValueError`` on any other device and
    on arguments the kernel does not take, ``NotImplementedError`` on CUDA
    for a custom model, and ``RuntimeError`` when the kernel does not
    build or launch, the cooperative grid included."""
    kw = dict(model=model, layout=layout, window_shape=window_shape,
              global_slots=global_slots, lo=lo, hi=hi, max_iter=max_iter,
              ftol=ftol, xtol=xtol, lam0=lam0, lam_up=lam_up,
              lam_down=lam_down, lam_max=lam_max, constraint=constraint)
    device = pixels.device
    if device.type == "cpu":
        return tied_lm_reference(vect0, const_params, pixels, mask, origin,
                                 norm, valid, fvalid, **kw)
    if device.type != "cuda":
        raise ValueError(f"tied_lm: unsupported device {device}")
    B = vect0.shape[0]
    n, P = layout.n_features, layout.n_params
    if fvalid is None:
        fvalid = torch.ones((B, n), dtype=torch.float32, device=device)
    check_tied_lm_args(vect0, const_params, pixels, mask, origin, norm,
                       valid, fvalid, model=model, layout=layout,
                       window_shape=window_shape, global_slots=global_slots,
                       constraint=constraint)
    D = len(window_shape)
    wz, wy, wx = (1,) + tuple(window_shape) if D == 2 else window_shape
    npix = wz * wy * wx
    f32, i32 = torch.float32, torch.int32
    tied, lo_k, hi_k = pack_tied(layout, constraint, global_slots, lo, hi)
    kp = KernelProblem(vect0, layout, model, constraint, lo, hi, device)
    V, G = kp.x0.shape[1], len(tied)
    K = (V + 1) * (V + 2) // 2
    NS = 1 + G + G * (G + 1) // 2
    # every host→device copy before the launch (KernelProblem's note)
    tied_t = torch.as_tensor(tied, device=device)
    lo_t = torch.as_tensor(lo_k, device=device)
    hi_t = torch.as_tensor(hi_k, device=device)
    lib = _library()
    valid_i = valid.to(i32)
    # scratch: the pixel lists and per-lane counters; x and items, current
    # and trial, and the lanes' maxima; the blocks' FP64 partials (a grid
    # is at most one block a lane)
    ws_i = torch.empty((B * npix + 3 * B + 1,), dtype=i32, device=device)
    ws_f = torch.empty((2 * B * V + 2 * B * K + 4 * B,), dtype=f32,
                       device=device)
    ws_d = torch.empty((B * (G + NS),), dtype=torch.float64, device=device)
    pi, pf, pd = ws_i.data_ptr(), ws_f.data_ptr(), ws_d.data_ptr()
    x_out = torch.empty((B, V), dtype=f32, device=device)
    cost = torch.empty((B,), dtype=f32, device=device)
    n_iter = torch.empty((B,), dtype=i32, device=device)
    conv = torch.empty((B,), dtype=i32, device=device)
    grid = ctypes.c_int(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.tied_lm_launch(
            pixels.data_ptr(), mask.data_ptr(), origin.data_ptr(),
            kp.x0.data_ptr(), const_params.data_ptr(), norm.data_ptr(),
            valid_i.data_ptr(), fvalid.data_ptr(), kp.slot_idx.data_ptr(),
            tied_t.data_ptr(), lo_t.data_ptr(), hi_t.data_ptr(),
            pi, pi + 4 * B * npix, pi + 4 * (B * npix + B),
            pi + 4 * (B * npix + 2 * B),
            pf, pf + 4 * 2 * B * V, pf + 4 * (2 * B * V + 2 * B * K),
            pd, pd + 8 * B * G, pf + 4 * (2 * B * V + 2 * B * K + 2 * B),
            B, n, P, V, G, int(layout.isotropic), D, wz, wy, wx,
            int(max_iter), float(ftol), float(xtol), float(lam0),
            float(lam_up), float(lam_down), float(lam_max),
            float(1e6 * lam0), *kp.args(),
            x_out.data_ptr(), cost.data_ptr(), n_iter.data_ptr(),
            conv.data_ptr(), pi + 4 * (B * npix + 3 * B),
            ctypes.byref(grid), stream,
        )
    if rc != 0:
        raise RuntimeError(f"tied_lm: kernel launch failed, cudaError {rc} "
                           f"(B={B}, grid {grid.value} blocks)")
    tied_lm.launches += 1
    tied_lm.last_grid = grid.value
    tied_lm.last_iterations = ws_i[-1:]
    return LMResult(x=kp.expand(x_out), cost=cost, n_iter=n_iter,
                    converged=conv.to(torch.bool), npix=mask.sum(dim=1))


tied_lm.launches = 0
tied_lm.last_grid = 0
tied_lm.last_iterations = None
