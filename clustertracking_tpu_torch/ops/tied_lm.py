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
  the whole joint loop in one launch, every built-in profile, the rigid
  poses of ``csrc/lm_core.cuh`` with their fitted distance tied) and
  counts the launch in ``tied_lm.launches``; on CPU tensors it returns
  the plain version's result.  ``launch_plan`` lays the launch out: a
  cooperative grid of one CTA an SM, each warp owning a fixed set of
  lanes.  It raises on anything the kernel does not take, when the build
  or the launch fails, and when the card cannot hold the grid; it never
  swaps in the plain version.
- ``tied_lm_reference`` is the plain PyTorch version: the call the bucket
  solver's plain route makes, ``ops/lm.py::lm_solve_global_shards`` on
  one ``GlobalShard`` with the bucket's ``make_model_fns`` (or, rigid,
  ``make_constrained_fns``) closures.
- ``tie_supported`` says whether the kernel takes a bucket's constraint
  once its distance is tied.

Both take::

    vect0 [B, V] f32 (a rigid constraint: [B, Qt + V] over refine.py's
    rigid layout), const_params [B, n, P] f32, pixels [B, Npix] f32
    (``window_gather``), mask [B, Npix] f32 (``radius_mask``: 0 or 1),
    origin [B, D] i32, norm [B] f32, valid [B] bool, fvalid [B, n] f32 or
    None, global_slots [V] bool, bounds (``ops/pixel_lm.py::SlotBounds``,
    whose ``tied`` puts the tied slots into the kernel's compact layout)

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
from .pixel_lm import (_CUDA_MAX_FEATURES, _CUDA_MAX_SLOTS, MODEL_ARGTYPES,
                       KernelProblem, _pose_words, _staged_extras,
                       profile_tag)
from .residual import make_model_fns
from .rigid import make_constrained_fns, rigid_kernel_slots, rigid_supported
from .window_gather import check_tensor

__all__ = ["TIED_MAX_SLOTS", "check_tied_lm_args", "launch_plan",
           "slot_ceiling", "tie_supported", "tied_lm", "tied_lm_clocks",
           "tied_lm_reference"]

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


def tied_lm_reference(vect0, const_params, pixels, mask, origin, norm,
                      valid, fvalid=None, *, model, layout, window_shape,
                      global_slots, bounds, max_iter=60, ftol=1.49e-8,
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
        (const_params, pixels, mask, origin, norm) + extra, bounds.lo,
        bounds.hi, valid)
    res = lm_solve_global_shards(
        [shard], global_slots, max_iter=max_iter, ftol=ftol, xtol=xtol,
        lam0=lam0, lam_up=lam_up, lam_down=lam_down, lam_max=lam_max)[0]
    return res._replace(npix=mask.sum(dim=1))


def check_tied_lm_args(vect0, const_params, pixels, mask, origin, norm,
                       valid, fvalid, *, model, layout, window_shape,
                       global_slots, bounds, constraint=None):
    """Raise on anything ``csrc/tied_lm.cu`` does not take: a custom model
    (``NotImplementedError``: no kernel evaluates a Python callable), a
    window rank other than 2 or 3, a parameter layout other than the
    model's, a constraint other than a rigid one the kernel inlines, no
    tied slot, ``TIED_MAX_SLOTS`` kernel slots or more, more features than
    ``csrc/lm_core.cuh`` stages, bounds built for another configuration or
    device, and tensors of the wrong dtype, shape, device or layout."""
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
    bounds.check(who, layout, constraint, V, device)


# csrc/tied_lm.cu's plan constants: a CTA's shared memory on an H100, the
# warps of a CTA by slot ceiling (lm_core.cuh's 8, 10, 14, 0 = the tile;
# one CTA an SM at the registers each sweep needs) and each ceiling's J
# tile in words
SMEM_MAX = 232448
CTA_WARPS = {8: 12, 10: 8, 14: 8, 0: 16}
_J_WORDS = {8: 4 * 32 * 9, 10: 3 * 32 * 11, 14: 2 * 32 * 15, 0: 32 * 21}
_CLOCKS = 10


def slot_ceiling(V):
    """lm_core.cuh's slot ceiling of V kernel slots: a register sweep
    (8, 10, 14) or the tile (0)."""
    return next((c for c in (8, 10, 14) if V <= c), 0)


def _smem_words(vm, V, G, ndim, profile, pose, W, lpw, state_smem, pool):
    """``smem_layout`` of csrc/tied_lm.cu in 4-byte words (slot ceiling
    vm, W warps)."""
    K = (V + 1) * (V + 2) // 2
    NS = 1 + G + G * (G + 1) // 2
    nx = _staged_extras(profile)
    core = (_J_WORDS[vm] + (_CUDA_MAX_SLOTS + 1) * (_CUDA_MAX_SLOTS + 2) // 2
            + _CUDA_MAX_SLOTS
            + _CUDA_MAX_FEATURES * (2 + 2 * ndim + nx) + 1
            + _CUDA_MAX_FEATURES * (1 + 2 * ndim + nx) + _pose_words(pose))
    core += core & 1
    words = (2 * (_CLOCKS + 1) + 2 * W * NS + 2 * G + 2 * NS
             + W * core + 2 * W + 2 + 2 * NS + G + 4 + NS + V)
    words += words & 1
    if state_smem:
        words += W * lpw * (2 * V + 2 * K + 4)
    return words + W * pool


def launch_plan(B, V, window, ndim, profile, pose, G, sms=132,
                ceiling=None):
    """How ``csrc/tied_lm.cu`` runs a bucket of B lanes, V kernel slots, G
    of them tied, on a card of ``sms`` SMs: a dict of ``ctas`` (the
    cooperative grid's, one an SM), ``warps`` (a CTA's),
    ``lanes_per_warp``, ``state_in_shared`` (the lanes' x and items in
    shared memory, else in global scratch), ``pool_words`` (each warp's
    pixel pool, ints), ``smem_bytes`` (a CTA's) and ``slot_ceiling``.  The
    grid takes as many CTAs as the card has SMs, up to one a lane, deals
    the lanes out CTA by CTA and gives a CTA a warp for each of its lanes
    or for each joint sum (the cost, the tied g and H entries and two
    maxima), whichever is more, up to CTA_WARPS.  The sweep is V's
    register one (``slot_ceiling(V)``) unless the tile's CTAs, which hold
    more warps, give a warp fewer lanes: measured on an H100
    (``chip_smoke.py --tied-kernels``), the register sweeps take 9–15%
    less time an iteration than the tile at one lane a warp either way,
    and the tile 20–27% less where it holds one lane a warp and they two.
    ``ceiling`` forces a slot ceiling that holds V (0: the tile), for
    measurement."""
    if ceiling is not None:
        return _layout(B, V, window, ndim, profile, pose, G, sms, ceiling)
    plan = _layout(B, V, window, ndim, profile, pose, G, sms,
                   slot_ceiling(V))
    if plan["slot_ceiling"]:
        tile = _layout(B, V, window, ndim, profile, pose, G, sms, 0)
        if tile["lanes_per_warp"] < plan["lanes_per_warp"]:
            return tile
    return plan


def _layout(B, V, window, ndim, profile, pose, G, sms, vm):
    """``launch_plan`` at slot ceiling vm."""
    if vm not in CTA_WARPS or 0 < vm < V:
        raise ValueError(f"tied_lm: slot ceiling {vm} for {V} slots")
    npix = int(np.prod(window))
    ctas = max(min(B, sms), 1)
    # a warp for each of a CTA's lanes, and one for each joint sum
    W = min(CTA_WARPS[vm], max(-(-B // ctas), 3 + G + G * (G + 1) // 2))
    lpw = max(-(-B // (ctas * W)), 1)
    limit = SMEM_MAX // 4
    base = _smem_words(vm, V, G, ndim, profile, pose, W, lpw, False, 0)
    if base > limit:
        raise ValueError(f"tied_lm: {4 * base} bytes of shared memory a CTA "
                         f"> {SMEM_MAX}")
    state_smem = _smem_words(vm, V, G, ndim, profile, pose, W, lpw, True,
                             0) <= limit
    rest = limit - _smem_words(vm, V, G, ndim, profile, pose, W, lpw,
                               state_smem, 0)
    pool = min(2 * lpw * npix, rest // W) & ~1
    words = _smem_words(vm, V, G, ndim, profile, pose, W, lpw, state_smem,
                        pool)
    return dict(ctas=ctas, warps=W, lanes_per_warp=lpw,
                state_in_shared=state_smem, pool_words=pool,
                smem_bytes=4 * words, slot_ceiling=vm)


_ARGTYPES = (
    [ctypes.c_void_p] * 12          # pixels .. hi
    + [ctypes.c_void_p] * 5         # scratch: list .. part_max
    + [ctypes.c_int] * 10           # B, n, P, V, G, iso, D, wz, wy, wx
    + [ctypes.c_int]                # max_iter
    + [ctypes.c_float] * 7          # ftol .. plateau
    + MODEL_ARGTYPES                # prof .. xn
    + [ctypes.c_void_p] * 5         # outputs, iterations
    + [ctypes.c_void_p]             # clocks (or null)
    + [ctypes.c_int] * 7            # vm, ctas, warps, lpw,
    + [ctypes.c_void_p]             # state_smem, pool, smem; stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("tied_lm")
    if lib.tied_lm_launch.argtypes is None:
        lib.tied_lm_launch.argtypes = _ARGTYPES
        lib.tied_lm_launch.restype = ctypes.c_int
    return lib


def tied_lm(vect0, const_params, pixels, mask, origin, norm, valid,
            fvalid=None, *, model, layout, window_shape, global_slots,
            bounds, max_iter=60, ftol=1.49e-8, xtol=1.49e-8, lam0=1e-3,
            lam_up=4.0, lam_down=0.25, lam_max=1e10, constraint=None):
    """The joint LM solve of one bucket (see the module docstring).

    CUDA tensors launch ``csrc/tied_lm.cu``, one launch for the whole loop,
    as ``launch_plan`` lays it out (its dict in ``tied_lm.last_plan``, the
    CTAs in ``tied_lm.last_grid``, the joint loop's iterations in the
    device tensor ``tied_lm.last_iterations``, for measurement); CPU
    tensors get ``tied_lm_reference``.  Raises ``ValueError`` on any other
    device and on arguments the kernel does not take,
    ``NotImplementedError`` on CUDA for a custom model, and
    ``RuntimeError`` when the kernel does not build or launch."""
    return _launch(vect0, const_params, pixels, mask, origin, norm, valid,
                   fvalid, None, None, model=model, layout=layout,
                   window_shape=window_shape, global_slots=global_slots,
                   bounds=bounds, max_iter=max_iter, ftol=ftol, xtol=xtol,
                   lam0=lam0, lam_up=lam_up, lam_down=lam_down,
                   lam_max=lam_max, constraint=constraint)


def tied_lm_clocks(vect0, const_params, pixels, mask, origin, norm, valid,
                   fvalid=None, ceiling=None, **kw):
    """``tied_lm`` on CUDA tensors that also returns each CTA's SM clock
    cycles ``[ctas, 10]`` int64, as its thread 0 sees them, summed over the
    joint iterations: in all, phase A's damped solves, the tie partials,
    the wait at the first barrier, the cross-CTA adds of the means, phase
    B's sweeps, the sweep partials, the wait at the second barrier, phase
    C's cross-CTA adds and decision, and the iterations counted.
    ``ceiling`` runs another slot ceiling's sweep (``launch_plan``; 0: the
    tile).  For measurement: ``chip_smoke.py --tied-kernels``."""
    clocks = torch.zeros((1024, _CLOCKS), dtype=torch.int64,
                         device=pixels.device)
    res = _launch(vect0, const_params, pixels, mask, origin, norm, valid,
                  fvalid, clocks, ceiling, **kw)
    return res, clocks[:tied_lm.last_grid]


def _launch(vect0, const_params, pixels, mask, origin, norm, valid, fvalid,
            clocks, ceiling, *, model, layout, window_shape, global_slots,
            bounds, max_iter=60, ftol=1.49e-8, xtol=1.49e-8, lam0=1e-3,
            lam_up=4.0, lam_down=0.25, lam_max=1e10, constraint=None):
    kw = dict(model=model, layout=layout, window_shape=window_shape,
              global_slots=global_slots, bounds=bounds, max_iter=max_iter,
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
                       bounds=bounds, constraint=constraint)
    D = len(window_shape)
    wz, wy, wx = (1,) + tuple(window_shape) if D == 2 else window_shape
    npix = wz * wy * wx
    f32, i32 = torch.float32, torch.int32
    kp = KernelProblem(vect0, model, bounds)
    tied = bounds.tied(global_slots)
    V, G = kp.x0.shape[1], len(tied)
    K = (V + 1) * (V + 2) // 2
    NS = 1 + G + G * (G + 1) // 2
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    plan = launch_plan(
        B, V, window_shape, D, kp.profile, kp.kernel.pose, G,
        sms=torch.cuda.get_device_properties(index).multi_processor_count,
        ceiling=ceiling)
    ctas = plan["ctas"]
    lib = _library()
    valid_i = valid.to(i32)
    # scratch: the pixel lists (offset, value pairs) and the iterations;
    # the lanes' state where shared memory does not hold it; the CTAs'
    # FP64 partials and maxima
    ws_i = torch.empty((2 * B * npix + 1,), dtype=i32, device=device)
    ls = 0 if plan["state_in_shared"] else (
        ctas * plan["warps"] * plan["lanes_per_warp"] * (2 * V + 2 * K + 4))
    ws_f = torch.empty((ls + 2 * ctas,), dtype=f32, device=device)
    ws_d = torch.empty((ctas * (G + NS),), dtype=torch.float64,
                       device=device)
    pf, pd = ws_f.data_ptr(), ws_d.data_ptr()
    x_out = torch.empty((B, V), dtype=f32, device=device)
    cost = torch.empty((B,), dtype=f32, device=device)
    n_iter = torch.empty((B,), dtype=i32, device=device)
    conv = torch.empty((B,), dtype=i32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.tied_lm_launch(
            pixels.data_ptr(), mask.data_ptr(), origin.data_ptr(),
            kp.x0.data_ptr(), const_params.data_ptr(), norm.data_ptr(),
            valid_i.data_ptr(), fvalid.data_ptr(),
            kp.kernel.slot_idx.data_ptr(),
            tied.data_ptr(), kp.kernel.lo.data_ptr(), kp.kernel.hi.data_ptr(),
            ws_i.data_ptr(), pf, pd, pd + 8 * ctas * G, pf + 4 * ls,
            B, n, P, V, G, int(layout.isotropic), D, wz, wy, wx,
            int(max_iter), float(ftol), float(xtol), float(lam0),
            float(lam_up), float(lam_down), float(lam_max),
            float(1e6 * lam0), *kp.args(),
            x_out.data_ptr(), cost.data_ptr(), n_iter.data_ptr(),
            conv.data_ptr(), ws_i.data_ptr() + 4 * 2 * B * npix,
            None if clocks is None else clocks.data_ptr(),
            plan["slot_ceiling"], ctas, plan["warps"],
            plan["lanes_per_warp"],
            int(plan["state_in_shared"]), plan["pool_words"],
            plan["smem_bytes"], stream,
        )
    if rc != 0:
        raise RuntimeError(f"tied_lm: kernel launch failed, cudaError {rc} "
                           f"(B={B}, plan {plan})")
    tied_lm.launches += 1
    tied_lm.last_grid = ctas
    tied_lm.last_plan = plan
    tied_lm.last_iterations = ws_i[-1:]
    return LMResult(x=kp.expand(x_out), cost=cost, n_iter=n_iter,
                    converged=conv.to(torch.bool), npix=mask.sum(dim=1))


tied_lm.launches = 0
tied_lm.last_grid = 0
tied_lm.last_plan = None
tied_lm.last_iterations = None
