"""refine_leastsq — the core fitting pipeline, in PyTorch.

Counterpart of ``clustertracking_tpu/refine.py``.  Clusters are bucketed
by cluster size; each bucket becomes one batched solve that fits every
cluster of the bucket together:

- window gather, fit-region mask, parameter packing, LM solve and the
  refit-on-shift outer loop (``max_iter``/``max_shift``) all run on the
  device that holds the frames; on CUDA each bucket takes the kernel route
  ``kernel_route`` names, decided once per device (``route_on``): 'fused' (2D
  windows, ``csrc/fused_lm_2d.cu``, whose launch runs every refit round
  itself, so a bucket's solve reads nothing back to the host), 'gathered'
  (3D and large 2D windows,
  ``csrc/window_gather.cu`` then ``csrc/pixel_lm.cu``, once per refit
  round), 'block' (unconstrained buckets of 20 slots or more, such as
  config 5's chains: ``csrc/window_gather.cu`` then
  ``csrc/block_lm.cu``), 'tied' (buckets with slots tied across lanes:
  ``csrc/window_gather.cu`` then ``csrc/tied_lm.cu``) or none
  (``ops/lm.py::lm_solve`` / ``lm_solve_global``);
- constrained buckets (``constraints=``) fit a rigid pose exactly
  (``ops/rigid.py``; on CUDA through the rigid instantiations of the same
  kernels) or, for reference-style dicts, the free positions with
  ``sqrt(residual_factor)``-weighted penalty rows (``lm_solve``);
- fits whose RMS residual (normalized by the cluster's signal scale)
  exceeds ``max_rms_dev`` are rejected: original values kept, ``cost``
  NaN;
- ``compute_error=True`` adds ``<name>_std`` columns from the
  Gauss–Newton covariance (through the pose map for rigid fits);
- clusters bigger than ``max_cluster_size`` spill to the host scipy path
  (hostref.py);
- 'global' parameter modes (the default of the inv_series coefficients)
  tie their slots across each dispatch's lanes in one joint solve, on the
  device of the frames: on CUDA one launch of ``csrc/tied_lm.cu``
  (``ops/tied_lm.py``; the reference solves them in XLA), else
  ``ops/lm.py::lm_solve_global``, and across a mesh's shards
  ``lm_solve_global_shards``; a rigid distance tied across
  every cluster (``dimer_global()``'s default) alternates a pooled Newton
  step on the whole video's distance with a refit at that distance fixed
  (``_joint_global_dist``), and reports it in ``out.attrs``.

Rows without a 'cluster' column are grouped by ``find.cluster_ids``, the
array core of ``find_clusters`` (``backend_find``: 'host', 'auto' or
'device', on the same device).  The DataFrame is read once, into the
arrays the fit needs; bucketing, lane assembly and write-back run on
them, and the output table is built once, at the end.
``mesh=`` (a ``parallel.sharding.make_mesh`` mesh) splits every bucket's
lanes over several devices (``_mesh_bucket_solver``).  pandas is
imported by the DataFrame entry points only.  ``train_leastsq``
(train.py) is exported from here too, as in the reference.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
import types
from functools import lru_cache
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from . import diagnostics
from .constraints import (
    circumradius_factor, pose_dim, positions_to_pose, wrap_constraint_dicts)
from .find import cluster_ids
from .models.packing import ParamLayout, build_layout
from .models.registry import ModelSpec, get_model
from .ops.collectives import Mesh, join_lanes, split_lanes
from .ops.block_lm import BLOCK_MAX_FEATURES, BLOCK_MAX_SLOTS, block_lm
from .ops.fused_lm import fused_lm_2d, fused_max_pixels
from .ops.gather import gather_stack, origins_for, radius_mask
from .ops.lm import GlobalShard, lm_solve, lm_solve_global_shards
from .ops.pixel_lm import (
    SlotBounds, _kernel_slots, launch_mode, pixel_lm, pose_kind, profile_tag,
    sum_path)
from .ops.residual import make_model_fns
from .ops.rigid import make_constrained_fns, rigid_supported
from .ops.tied_lm import tie_supported, tied_lm
from .ops.window_gather import window_gather
from .utils import default_size_columns, guess_pos_columns, validate_tuple
from .utils.device import _resolve_device

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["refine_leastsq", "train_leastsq"]

_LANE_PAD = 32  # lanes are padded to multiples of this (reference parity)

_LM_BACKENDS = ("auto", "kernel", "torch")
_GATHER_BACKENDS = ("auto", "torch")

# Buckets with this many kernel slots or more leave the warp kernels
# (csrc/lm_core.cuh's kMaxSlots) for the block kernel, csrc/block_lm.cu, up
# to its BLOCK_MAX_SLOTS; past that, or constrained, they take lm_solve.
# The threshold is the reference's MXU crossover (pallas_lm.py:235), not
# yet re-measured between the warp and the block kernels on the H100.
_KERNEL_MAX_SLOTS = 20
# Largest window, in pixels, the reference's kernels take (its streaming
# cap, pallas_lm.py:148).
_MAX_WINDOW_PIXELS = 1 << 18


def kernel_route(model: ModelSpec, layout: ParamLayout, use_global: bool,
                 constraint, window_shape):
    """The kernel route of a bucket configuration: 'fused', 'gathered',
    'block', 'tied' or None (``lm_solve``, or ``lm_solve_global`` for a
    tied bucket).

    The reference's ``pallas_available`` decides warp kernel or not:
    zero-slot layouts, buckets at or past ``_KERNEL_MAX_SLOTS`` kernel
    slots (a rigid bucket's compact length) and windows past
    ``_MAX_WINDOW_PIXELS`` leave the warp kernels, and so do generic
    (penalty) constraints and rigid ones the kernels do not inline
    (positions not all fitted).  Its ``fused_ok`` decides which: 2D
    windows within ``fused_max_pixels`` are fused (``csrc/fused_lm_2d.cu``),
    3D windows and larger 2D ones are gathered (``window_gather``, then
    ``csrc/pixel_lm.cu``; a rigid 2D bucket too large to fuse takes
    ``lm_solve``).  Where the reference takes XLA's ``lm_solve`` for an
    unconstrained bucket of ``_KERNEL_MAX_SLOTS`` to ``BLOCK_MAX_SLOTS``
    slots and at most ``BLOCK_MAX_FEATURES`` features (config 5's
    chains), the port takes 'block': ``window_gather``, then
    ``csrc/block_lm.cu``.  Where it takes XLA's ``lm_solve_global`` for a
    bucket with slots tied across lanes ('global' modes, a
    ``dimer_global()`` distance), the port takes 'tied' (``window_gather``,
    then ``ops/tied_lm.py::tied_lm``, ``csrc/tied_lm.cu``) for fewer than
    ``_KERNEL_MAX_SLOTS`` kernel slots in a window within
    ``_MAX_WINDOW_PIXELS``, unconstrained or rigid as ``tie_supported``
    says (the warp kernels' poses with the distance tied); a tied bucket
    of more slots or with a generic constraint takes ``lm_solve_global``.
    Untied constrained buckets of ``_KERNEL_MAX_SLOTS`` or more, and
    larger ones, take ``lm_solve``.  A custom model (``profile_tag``
    None) is a Python callable no CUDA kernel can evaluate, so its
    buckets take ``lm_solve`` or ``lm_solve_global``.  Every choice is
    static, made before any launch, not a fallback."""
    prof = profile_tag(model)
    if prof is None or not (
            tie_supported(layout, constraint) if use_global
            else constraint is None or rigid_supported(layout, constraint)):
        return None
    n_slots = _kernel_slots(layout, constraint)
    npix = int(np.prod(window_shape))
    if n_slots < 1 or npix > _MAX_WINDOW_PIXELS:
        return None
    if use_global:
        return "tied" if n_slots < _KERNEL_MAX_SLOTS else None
    if n_slots >= _KERNEL_MAX_SLOTS:
        if (constraint is None and n_slots <= BLOCK_MAX_SLOTS
                and layout.n_features <= BLOCK_MAX_FEATURES):
            return "block"
        return None
    if len(window_shape) == 2:
        if npix <= fused_max_pixels(prof, pose_kind(layout, constraint)):
            return "fused"
        return None if constraint is not None else "gathered"
    return "gathered"


def _slot_bounds(layout, window_shape, frame_shape, bounds_key=(),
                 constraint=None, device="cpu"):
    """The ``SlotBounds`` of a bucket on ``device``: per-slot f32 (lo, hi)
    of the optimizer vector, the user's ``bounds`` (name, lo, hi) tuples
    plus the implicit ones — positions stay inside the frame (a lane whose
    gradient vanishes cannot random-walk away) and sizes stay in [0.05,
    largest window extent] (a size through zero makes r² = 0/0).

    A rigid ``constraint`` prepends its Qt pose slots: the center stays in
    the frame, a fitted distance in [1e-3, (min window − 1)/(2·circ)] (the
    vertices stay inside the window); the inert position slots are not
    bounded, and the other slots' bounds shift by Qt.  (The reference
    bounds a rigid bucket's sizes at the unshifted index, refine.py:415;
    ROADMAP queue 3.)"""
    rigid = constraint is not None and constraint.kind == "rigid"
    Qt = pose_dim(constraint) + int(constraint.fit_dist) if rigid else 0
    V = layout.n_slots
    lo = np.full(Qt + V, -np.inf, np.float32)
    hi = np.full(Qt + V, np.inf, np.float32)
    for name, b_lo, b_hi in bounds_key:
        p = layout.param_names.index(name)
        for s in layout.slot_idx[:, p]:
            if s >= 0:
                lo[Qt + s] = b_lo
                hi[Qt + s] = b_hi
    if rigid:
        for d in range(layout.ndim):
            lo[d], hi[d] = 0.0, float(frame_shape[d] - 1)
        if constraint.fit_dist:
            circ = circumradius_factor(layout.n_features, layout.ndim)
            lo[Qt - 1] = max(lo[Qt - 1], 1e-3)
            hi[Qt - 1] = min(hi[Qt - 1],
                             (min(window_shape) - 1) / (2.0 * circ))
    else:
        for d, p in enumerate(layout.pos_param_idx):
            for s in layout.slot_idx[:, p]:
                if s >= 0:
                    lo[s] = 0.0
                    hi[s] = float(frame_shape[d] - 1)
    for p in layout.size_param_idx:
        for s in layout.slot_idx[:, p]:
            if s >= 0:
                lo[Qt + s] = max(lo[Qt + s], 0.05)
                hi[Qt + s] = min(hi[Qt + s], float(max(window_shape)))
    return SlotBounds(layout, constraint, lo, hi, device)


@lru_cache(maxsize=256)
def _bucket_solver(*args, **kw):
    """Build the solver for one bucket configuration on one device.

    Arguments as ``_shard_solver``'s.  Returns ``(solve, layout)``;
    ``solve(frames [T, *S] f32, frame_idx [B] i32, params0 [B, n, P] f32,
    pose0 [B, Qt], valid [B] bool, fvalid [B, n] f32 | None) -> (params,
    rms, converged, iters, std)`` runs on the device of ``frames``.
    ``pose0`` is [B, 0] for an unconstrained or generic bucket and the
    initial pose (``positions_to_pose``) for a rigid one; constrained
    buckets are exact-size and ignore ``fvalid``.
    """
    solve_shards, layout, _, _ = _shard_solver(*args, **kw)

    def solve(frames, frame_idx, params0, pose0, valid, fvalid=None):
        return solve_shards([(frames, frame_idx, params0, pose0, valid,
                              fvalid)])[0]

    return solve, layout


@lru_cache(maxsize=256)
def _shard_solver(
    model: ModelSpec,
    ndim: int,
    isotropic: bool,
    n: int,
    param_mode_key: tuple,
    window_shape: tuple,
    radius: tuple,
    bounds_key: tuple,
    constraint,
    residual_factor: float,
    max_iter: int,
    max_shift: float,
    lm_max_iter: int,
    ftol: float,
    xtol: float,
    compute_error: bool,
    lm_backend: str = "auto",
    gather_backend: str = "auto",
    streaming=None,
):
    """Build one bucket configuration's solver over lanes split into
    shards.

    Returns ``(solve_shards, layout, use_global, route_on)``:
    ``solve_shards`` takes a list of per-shard argument tuples (those of
    ``_bucket_solver``'s ``solve``, each on its shard's device; several
    only for a tied bucket) and returns one output tuple per shard;
    ``use_global`` says whether the bucket ties slots across lanes;
    ``route_on(device, shards=1)`` is its route on a device.  The route
    per device, the bounds (``SlotBounds``) per device and frame shape and
    the model closures per device, where something calls them, are built
    once.  ``residual_factor`` weighs a generic constraint's
    penalty rows (by its square root).

    ``lm_backend`` as ``refine_leastsq``'s.  ``gather_backend``: 'auto'
    gathers windows with ``window_gather`` (the CUDA kernel on CUDA,
    ``gather_stack`` on CPU), 'torch' with ``gather_stack``.
    ``streaming``: ``pixel_lm``'s mode on the gathered route (None picks
    by occupancy; True / False force streamed / resident), as the
    reference's ``make_pallas_lm`` takes it.
    """
    if lm_backend not in _LM_BACKENDS:
        raise ValueError(f"Unknown lm_backend {lm_backend!r}; "
                         f"one of {_LM_BACKENDS}")
    if gather_backend not in _GATHER_BACKENDS:
        raise ValueError(f"Unknown gather_backend {gather_backend!r}; "
                         f"one of {_GATHER_BACKENDS}")
    gather = window_gather if gather_backend == "auto" else gather_stack
    layout = build_layout(model, ndim, isotropic, n, dict(param_mode_key))
    use_global = _uses_global(layout, constraint)
    pos_idx = list(layout.pos_param_idx)
    # the positions are the ndim params after signal: a slice, which
    # copies no index to the device
    pos_cols = slice(pos_idx[0], pos_idx[0] + ndim)
    route = kernel_route(model, layout, use_global, constraint, window_shape)
    if lm_backend == "kernel" and route is None:
        raise ValueError(
            "lm_backend='kernel' unsupported for this configuration "
            f"(V={layout.n_slots} slots, n={n}, window {window_shape}, "
            f"constraint {getattr(constraint, 'name', None)!r}, "
            f"global-tied slots {use_global}): the kernels take no custom "
            f"model, no window past {_MAX_WINDOW_PIXELS} pixels, no tied "
            f"or constrained bucket of {_KERNEL_MAX_SLOTS} kernel slots or "
            "more, no tied bucket under a generic constraint and no bucket "
            f"past {BLOCK_MAX_SLOTS} slots or {BLOCK_MAX_FEATURES} features"
        )
    gslots = _tied_slots(layout, constraint) if use_global else None
    kind = ("" if constraint is None else "-rigid"
            if constraint.kind == "rigid" else "-penalty")
    kind += "-global" if use_global else ""
    # the LM wrappers' keywords that do not change from call to call
    lm_kw = dict(model=model, layout=layout, window_shape=window_shape,
                 max_iter=lm_max_iter, ftol=ftol, xtol=xtol)
    warp_kw = dict(lm_kw, radius=radius, constraint=constraint)

    @lru_cache(maxsize=None)
    def fns_on(device):
        """The model closures on ``device``: ``make_model_fns``'s, or a
        constrained bucket's ``make_constrained_fns``."""
        if constraint is None:
            return make_model_fns(model, layout, window_shape, device=device)
        return make_constrained_fns(model, layout, window_shape, constraint,
                                    residual_factor, device)

    @lru_cache(maxsize=8)   # bounded: the callers choose the frame shapes
    def bounds_on(device, frame_shape):
        return _slot_bounds(layout, window_shape, frame_shape, bounds_key,
                            constraint, device)

    def positions_of(sh, vect):
        if constraint is None:
            return layout.vect_to_params(vect, sh.params0)[..., pos_cols]
        return fns_on(sh.device).positions_of(vect, sh.params0)

    def setup(frames, frame_idx, params0, pose0, valid, fvalid=None):
        """One shard's (or the whole bucket's) solve state, on the device
        of ``frames``."""
        sh = types.SimpleNamespace(
            frames=frames, frame_idx=frame_idx, params0=params0,
            valid=valid, device=frames.device, B=params0.shape[0],
            frame_shape=tuple(frames.shape[1:]))
        sh.bounds = bounds_on(sh.device, sh.frame_shape)
        signal0 = params0[..., layout.signal_param_idx]
        sh.norm = torch.clamp(torch.amax(torch.abs(signal0), dim=1),
                              min=1e-6)
        if constraint is None:
            sh.vect0 = layout.vect_from_params(params0)
        else:
            # constrained buckets are exact-size: no pad features to gate
            fvalid = None
            sh.vect0 = fns_on(sh.device).vect_of(params0,
                                                 pose0.to(params0.dtype))
        sh.fvalid = fvalid
        sh.fv_extra = () if fvalid is None else (fvalid,)
        return sh

    window_arg = "x".join(map(str, window_shape))

    def gather_windows(sh, origin):
        """The windows of ``sh``'s lanes at ``origin``, in the
        ``solver.gather`` range."""
        with diagnostics.stage("solver.gather",
                               {"B": sh.B, "window": window_arg}):
            return gather(sh.frames, sh.frame_idx, origin, window_shape)

    def window_of(sh, vect):
        """(positions, window origins) at ``vect``."""
        pos_at = positions_of(sh, vect).contiguous()
        return pos_at, origins_for(pos_at, window_shape, sh.frame_shape)

    def masked_windows(sh, vect):
        """(positions, origins, windows, fit mask) at ``vect``."""
        pos_at, origin = window_of(sh, vect)
        pixels = gather_windows(sh, origin)
        return pos_at, origin, pixels, radius_mask(
            pos_at, origin, window_shape, radius, fvalid=sh.fvalid)

    def each_shard(one):
        """A round of every shard, each on its own: ``one(sh, vect, need)``
        of each."""
        return lambda shs, vects, needs: list(map(one, shs, vects, needs))

    # One refit round of each route; the wrappers are looked up in this
    # module when a round runs, so that a caller may wrap them.
    @each_shard
    def fused_round(sh, vect, need):
        pos_at, origin = window_of(sh, vect)
        return fused_lm_2d(vect, sh.params0, sh.frames, sh.frame_idx, pos_at,
                           origin, sh.norm, need, sh.fvalid,
                           bounds=sh.bounds, **warp_kw), pos_at

    @each_shard
    def fused_refit(sh, vect, need):
        """Every refit round of one shard in one ``fused_lm_2d`` launch,
        on the device: (best x, rms, converged, iterations)."""
        res = fused_lm_2d(vect, sh.params0, sh.frames, sh.frame_idx, None,
                          None, sh.norm, need, sh.fvalid, bounds=sh.bounds,
                          rounds=max(max_iter, 1), max_shift=max_shift,
                          **warp_kw)
        return res.x, res.rms, res.converged, res.n_iter

    @each_shard
    def gathered_round(sh, vect, need):
        pos_at, origin = window_of(sh, vect)
        mode = route_on(sh.device).mode
        return pixel_lm(vect, sh.params0, gather_windows(sh, origin), pos_at,
                        origin, sh.norm, need, sh.fvalid, bounds=sh.bounds,
                        streaming=None if mode is None
                        else mode == "streamed", **warp_kw), pos_at

    @each_shard
    def block_round(sh, vect, need):
        pos_at, origin, pixels, mask = masked_windows(sh, vect)
        return block_lm(vect, sh.params0, pixels, mask, origin, sh.norm,
                        need, sh.fvalid, bounds=sh.bounds, **lm_kw), pos_at

    @each_shard
    def torch_round(sh, vect, need):
        """``lm_solve`` on the bucket's closures (``block_lm``'s plain
        version, on an unconstrained bucket)."""
        pos_at, origin, pixels, mask = masked_windows(sh, vect)
        fns = fns_on(sh.device)
        return lm_solve(
            fns.residual, fns.residual_jac, vect,
            (sh.params0, pixels, mask, origin, sh.norm) + sh.fv_extra,
            max_iter=lm_max_iter, ftol=ftol, xtol=xtol,
            lower=sh.bounds.lo, upper=sh.bounds.hi, valid=need,
        )._replace(npix=mask.sum(dim=1)), pos_at

    @each_shard
    def tied_round(sh, vect, need):
        """The joint round on one shard: ``tied_lm`` (the kernel on CUDA,
        its plain version on CPU)."""
        pos_at, origin, pixels, mask = masked_windows(sh, vect)
        return tied_lm(vect, sh.params0, pixels, mask, origin, sh.norm, need,
                       sh.fvalid, global_slots=gslots, bounds=sh.bounds,
                       constraint=constraint, **lm_kw), pos_at

    def global_round(shs, vects, needs):
        """ONE joint ``lm_solve_global_shards`` over every shard's lanes,
        the windows gathered on each shard's device and the sums
        all-reduced."""
        parts, masks, pos_ats = [], [], []
        for sh, vect, need in zip(shs, vects, needs):
            pos_at, origin, pixels, mask = masked_windows(sh, vect)
            fns = fns_on(sh.device)
            parts.append(GlobalShard(
                fns.residual, fns.residual_jac, vect,
                (sh.params0, pixels, mask, origin, sh.norm) + sh.fv_extra,
                sh.bounds.lo, sh.bounds.hi, need))
            masks.append(mask)
            pos_ats.append(pos_at)
        results = lm_solve_global_shards(
            parts, gslots, max_iter=lm_max_iter, ftol=ftol, xtol=xtol)
        return [(res._replace(npix=mask.sum(dim=1)), pos_at)
                for res, mask, pos_at in zip(results, masks, pos_ats)]

    rounds = dict(fused=fused_round, gathered=gathered_round,
                  block=block_round, tied=tied_round,
                  torch=global_round if use_global else torch_round)

    @lru_cache(maxsize=None)
    def route_on(device, shards=1):
        """The route on ``device`` over ``shards`` shards, decided once: a
        record of ``taken`` ('fused', 'gathered', 'block', 'tied' or
        'torch'), ``tag`` (the dispatches' ``diagnostics`` backend:
        ``cuda-fused``, ``cpu-torch-rigid``, ...), ``mode`` and ``sums``
        (``pixel_lm``'s, where the gathered route runs on CUDA, else
        None), ``span_args`` (``solver.kernel``'s), ``solve(shs, vects,
        needs)``, one refit round: (LMResult, gather-time positions) a
        shard, and ``refit``: where the rounds run on the device (the
        fused route on CUDA), ``refit(shs, vects, needs)``, the whole
        refit loop: (best x, rms, converged, iterations) a shard, with
        nothing read back to the host; else None, and the host runs the
        rounds.  'auto' takes the bucket's kernel route (``kernel_route``)
        on CUDA; 'kernel' forces it (its plain versions on CPU); 'torch',
        a bucket with no kernel route and a tie across shards, whose sums
        cross devices, take lm_solve (lm_solve_global_shards when
        tied)."""
        taken = route if route is not None and not (
            use_global and shards > 1) and (lm_backend == "kernel" or (
                lm_backend == "auto" and device.type == "cuda")) else "torch"
        span_args = {"route": taken}
        if taken == "gathered" and device.type == "cuda":
            span_args.update(
                mode=launch_mode(model, layout, constraint, window_shape,
                                 device, streaming),
                sums=sum_path(model, layout, constraint))
        refit = (fused_refit if taken == "fused" and device.type == "cuda"
                 else None)
        if refit is not None:
            span_args["refit"] = "device"
        return types.SimpleNamespace(
            taken=taken, tag=f"{device.type}-{taken}{kind}",
            mode=span_args.get("mode"), sums=span_args.get("sums"),
            span_args=span_args, solve=rounds[taken], refit=refit)

    def finish(sh, vect_best, rms_best, conv_best, iters):
        """The outputs of one shard, with ``compute_error``'s std."""
        device, params0, fvalid = sh.device, sh.params0, sh.fvalid
        params = (layout.vect_to_params(vect_best, params0)
                  if constraint is None
                  else fns_on(device).params_of(vect_best, params0))
        if not compute_error:
            return (params, rms_best, conv_best, iters,
                    torch.zeros((0,), device=device))
        fns = fns_on(device)
        pos = positions_of(sh, vect_best)
        origin = origins_for(pos, window_shape, sh.frame_shape)
        pixels = gather(sh.frames, sh.frame_idx, origin, window_shape)
        mask = radius_mask(pos, origin, window_shape, radius, fvalid=fvalid)
        r, J = fns.residual_jac(
            vect_best, params0, pixels, mask, origin, sh.norm, *sh.fv_extra
        )
        H = torch.einsum("bun,bvn->buv", J, J)
        Vc = H.shape[-1]
        eye = torch.eye(Vc, dtype=H.dtype, device=device)
        # Cholesky-based inverse with a jitter that scales with the
        # diagonal, so a nearly singular H stays positive definite; a lane
        # whose H is still not positive definite gets NaN, as in JAX.
        diag_max = torch.clamp(
            torch.amax(torch.diagonal(H, dim1=-2, dim2=-1), dim=-1),
            min=1e-30,
        )
        jitter = (3e-7 * diag_max)[:, None, None] * eye
        L, info = torch.linalg.cholesky_ex(H + jitter)
        cov = torch.cholesky_inverse(L)
        cov = torch.where((info == 0)[:, None, None], cov, torch.nan)
        npx = torch.clamp(torch.sum(mask, dim=1), min=1.0)
        dof = torch.clamp(npx - Vc, min=1.0)
        sigma2 = torch.sum(r * r, dim=1) / dof
        var = torch.clamp(
            torch.diagonal(cov, dim1=-2, dim2=-1), min=0.0
        ) * sigma2[:, None]
        std_vect = torch.sqrt(var)
        nan_params = torch.full(params.shape, torch.nan, device=device)
        if constraint is None or constraint.kind != "rigid":
            return (params, rms_best, conv_best, iters,
                    layout.vect_to_params(std_vect, nan_params))
        # Delta method: the pose covariance through the pose→positions map
        # (G = ∂pos/∂vect, per lane) gives per-coordinate position errors;
        # the other slots map directly.
        G = torch.func.vmap(torch.func.jacfwd(
            lambda v: positions_of(sh, v[None])[0]))(vect_best)  # [B,n,D,Vc]
        var_pos = torch.einsum("bndu,buv,bndv->bnd", G, cov, G) \
            * sigma2[:, None, None]
        std_params = layout.vect_to_params(std_vect[:, fns.Qt:], nan_params)
        p0 = pos_idx[0]
        std_params = torch.cat(
            [std_params[..., :p0], torch.sqrt(torch.clamp(var_pos, min=0.0)),
             std_params[..., p0 + ndim:]], dim=-1)
        return params, rms_best, conv_best, iters, std_params

    def solve_shards(shard_args):
        """The refit-on-shift loop over lanes split into shards, in
        lockstep: every shard runs the same rounds, and the loop stops
        when no lane of any shard still needs a round.  A tied bucket's
        round is one joint solve over every shard (its sums all-reduced);
        an untied bucket's rounds are each shard's own.  Where the route
        runs the rounds on the device (``refit``), each shard's loop is
        one launch and the call returns without waiting for it."""
        with diagnostics.stage("solver.setup", {
                "n": n, "B": sum(a[2].shape[0] for a in shard_args)}):
            shs = [setup(*a) for a in shard_args]
            route = route_on(shs[0].device, len(shs))
            vect = [sh.vect0 for sh in shs]
            need = [sh.valid for sh in shs]
            if route.refit is None:
                # Refit-on-shift: a lane whose positions moved more than
                # max_shift is re-gathered around its new positions and
                # solved again.  The next round starts from the latest
                # iterate, but the REPORTED fit is each lane's best finite
                # round (re-centering changes the data a lane is fit
                # against, and a later round can be worse).
                iters = [torch.zeros((sh.B,), dtype=torch.int32,
                                     device=sh.device) for sh in shs]
                vect_best = list(vect)
                rms_best = [torch.full((sh.B,), torch.inf, device=sh.device)
                            for sh in shs]
                conv_best = [torch.zeros((sh.B,), dtype=torch.bool,
                                         device=sh.device) for sh in shs]
        if route.refit is not None:
            with diagnostics.stage("solver.round", {"round": 0}), \
                    diagnostics.stage("solver.kernel", route.span_args):
                best = route.refit(shs, vect, need)
        else:
            best = host_rounds(route, shs, vect, need, vect_best, rms_best,
                               conv_best, iters)
        with diagnostics.stage("solver.finish"):
            return [finish(sh, *b) for sh, b in zip(shs, best)]

    def host_rounds(route, shs, vect, need, vect_best, rms_best, conv_best,
                    iters):
        """The refit loop on the host, one ``route.solve`` a round, from
        the carry ``vect_best`` .. ``iters`` (lists a shard): (best x, rms,
        converged, iterations) a shard."""
        kernel_args = route.span_args
        for it in range(max(max_iter, 1)):
            with diagnostics.stage("solver.round", {"round": it}):
                if it > 0 and not any(bool(nd.any()) for nd in need):
                    break
                with diagnostics.stage("solver.kernel", kernel_args):
                    rounds_out = route.solve(shs, vect, need)
                for s, (sh, (res, pos_at)) in enumerate(zip(shs,
                                                            rounds_out)):
                    shift = torch.amax(
                        torch.abs(positions_of(sh, res.x) - pos_at),
                        dim=(1, 2)
                    )
                    npx_raw = res.npix
                    npx = torch.clamp(npx_raw, min=1.0)
                    # an empty fit mask (every feature outside its window)
                    # has residual ≡ 0 — that is a FAILED fit, not a
                    # perfect one
                    rms_new = torch.where(
                        npx_raw > 0.0, torch.sqrt(res.cost / npx), torch.inf
                    )
                    iters[s] = iters[s] + torch.where(need[s], res.n_iter, 0)
                    improved = need[s] & (rms_new < rms_best[s])
                    vect_best[s] = torch.where(improved[:, None], res.x,
                                               vect_best[s])
                    rms_best[s] = torch.where(improved, rms_new, rms_best[s])
                    conv_best[s] = torch.where(improved, res.converged,
                                               conv_best[s])
                    need[s] = need[s] & (shift > max_shift)
                    vect[s] = res.x
        return list(zip(vect_best, rms_best, conv_best, iters))

    return solve_shards, layout, use_global, route_on


def _mesh_bucket_solver(mesh, model, ndim, isotropic, n, param_mode_key,
                        window_shape, radius, bounds_key, constraint,
                        residual_factor, max_iter, max_shift, lm_max_iter,
                        ftol, xtol, compute_error, lm_backend="auto",
                        gather_backend="auto", streaming=None):
    """The bucket solver over a ``Mesh``: the multi-device user-API path.

    Lanes (the cluster batch) split into ``mesh.size`` contiguous blocks,
    block ``s`` on ``mesh.devices[s]``; the frames go whole to each
    distinct device, once.  Two routes:

    - untied buckets (free, and rigid without a shared distance): each
      shard runs ``_shard_solver``'s refit-on-shift loop on its own
      device and lanes, through the kernel route ``kernel_route`` picks
      there; lanes are independent, so no collective is needed and each
      lane's result is the single-device one;
    - tied buckets ('global' modes, a ``dimer_global()`` distance): the
      refit loop runs in lockstep over the shards, each round one joint
      ``lm_solve_global_shards`` whose sums over lanes are all-reduced
      (``ops/collectives.py::all_reduce``) — what GSPMD inserts in the
      reference.  Over more than one shard this is the tie's static
      route on every device (``csrc/tied_lm.cu`` sums within one launch
      on one device); a mesh of one shard takes the bucket's route.

    Returns ``(call, layout, backend_tag)``: ``call`` takes and returns
    what the single-device solver does, its outputs joined in lane order
    on the mesh's first device; the tag is the route's on the first
    device with ``-sharded`` appended (``cuda-fused-sharded``, and for a
    tie over several shards ``cuda-torch-global-sharded``, ...)."""
    solve_shards, layout, use_global, route_on = _shard_solver(
        model, ndim, isotropic, n, param_mode_key, window_shape, radius,
        bounds_key, constraint, residual_factor, max_iter, max_shift,
        lm_max_iter, ftol, xtol, compute_error, lm_backend, gather_backend,
        streaming)
    dev0 = mesh.devices[0]
    backend_tag = route_on(dev0, mesh.size).tag + "-sharded"

    def call(stack, fidx, params0, pose0, valid, fvalid=None):
        with diagnostics.stage("solver.setup", {
                "n": n, "B": params0.shape[0], "shards": mesh.size}):
            lanes = [None if a is None else torch.as_tensor(a)
                     for a in (fidx, params0, pose0, valid, fvalid)]
            shards = split_lanes(mesh, lanes, shared=(
                torch.as_tensor(stack, dtype=torch.float32),))
        if use_global:   # one lockstep loop, its ties across every shard
            outs = solve_shards(shards)
        else:            # each shard's own loop
            outs = [solve_shards([a])[0] for a in shards]
        with diagnostics.stage("solver.finish"):
            joined = [join_lanes(parts, dev0) for parts in zip(*outs)]
            if not compute_error:   # the std placeholder has no lanes
                joined[4] = outs[0][4].to(dev0)
        return tuple(joined)

    return call, layout, backend_tag


def _global_distance(constraint) -> bool:
    """A rigid constraint whose fitted distance is one for every cluster."""
    return (constraint is not None and constraint.kind == "rigid"
            and constraint.fit_dist and constraint.dist_mode == "global")


def _tied_slots(layout, constraint):
    """[V] bool: the slots of a tied bucket's solve vector that are tied
    across lanes.  A rigid bucket's vector is [pose, distance, std
    slots], so a shared distance is slot Qt − 1 and the model's 'global'
    slots follow at Qt + s."""
    Qt = (pose_dim(constraint) + int(constraint.fit_dist)
          if constraint is not None and constraint.kind == "rigid" else 0)
    gslots = np.zeros(Qt + layout.n_slots, dtype=bool)
    if _global_distance(constraint):
        gslots[Qt - 1] = True
    gslots[Qt:] = layout.global_slots
    return gslots


def _uses_global(layout, constraint) -> bool:
    """A bucket with slots tied across lanes: 'global' parameter modes or a
    globally shared rigid distance (solved by ``lm_solve_global``)."""
    return bool(np.any(layout.global_slots) or _global_distance(constraint))


# (kernel, wrapper, counter): the wrappers as imported, apart from the
# module names the solver calls through, which a caller may wrap
_COUNTERS = (("fused_lm_2d", fused_lm_2d, "launches"),
             ("pixel_lm_resident", pixel_lm, "launches_resident"),
             ("pixel_lm_streamed", pixel_lm, "launches_streamed"),
             ("pixel_lm_mma", pixel_lm, "launches_mma"),
             ("block_lm", block_lm, "launches"),
             ("tied_lm", tied_lm, "launches"),
             ("window_gather", window_gather, "launches"))


def _launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    return {k: getattr(fn, attr) for k, fn, attr in _COUNTERS}


def _launches_since(before: dict) -> dict:
    """{kernel: launches} since ``before`` (``_launch_counts()``), those
    that launched only."""
    return {k: v - before[k] for k, v in _launch_counts().items()
            if v != before[k]}


def _clock_mark(device):
    """A mark on a dispatch's timeline: on CUDA an event recorded on the
    device's current stream (device time), else the host clock."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def _clock_seconds(start, stop) -> float:
    """Seconds between two ``_clock_mark``s; CUDA events only once the
    device has passed the second (after the dispatch's fetch)."""
    if isinstance(start, float):
        return stop - start
    return start.elapsed_time(stop) / 1e3


def _pack_results(params, rms, conv, iters, std, compute_error):
    """A bucket's solver outputs as ONE [B, X] f32 tensor (one copy to the
    host per bucket); conv packs as 0/1 and iters as f32 (exact below
    2²⁴)."""
    B = params.shape[0]
    cols = [
        params.reshape(B, -1),
        rms[:, None],
        conv[:, None].to(torch.float32),
        iters[:, None].to(torch.float32),
    ]
    if compute_error:
        cols.append(std.reshape(B, -1))
    return torch.cat(cols, dim=1)


# Ladder steps for unconstrained cluster sizes (the reference's, kept for
# parity; to be re-measured on the H100).
_SIZE_LADDER = (1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32)


def _ladder_size(n: int) -> int:
    """Quantized bucket size for an unconstrained n-feature cluster.

    Sizes above 4 round UP to a ladder step (5→6, 7→8, 13→16, …); the
    cluster pads with INERT features (fvalid gates their model image,
    Jacobian rows and mask pixels to exactly zero), so one solver covers
    several sizes."""
    for step in _SIZE_LADDER:
        if step >= n:
            return step
    return -(-n // 8) * 8


def _window_shape(n, ndim, radius, separation, frame_shape):
    """Static window extent per bucket: cluster bbox + radius margin.

    Connected components at threshold `separation` bound an n-chain's
    bbox by (n-1)*separation per axis."""
    w = []
    for d in range(ndim):
        ext = int(math.ceil((n - 1) * separation[d] + 2 * radius[d])) + 3
        w.append(min(ext, frame_shape[d]))
    return tuple(w)


def _frames_of(reader, frame_numbers, ndim=None):
    """Fetch frames as a dict {frame_no: ndarray | torch.Tensor}.

    Accepts a bare array (a SINGLE image shared by every frame — only
    when its rank equals the fit's ``ndim``, so a [T, H, W] video stack
    is indexed per frame rather than mistaken for one 3D z-stack), a
    reader supporting __getitem__, or a [T, ...] stack.  Frames that are
    already torch tensors are kept as they are."""
    if isinstance(reader, (np.ndarray, torch.Tensor)) and (
        reader.ndim == ndim
        or (ndim is None and reader.ndim in (2, 3))
    ):
        return {int(t): reader for t in frame_numbers}
    out = {}
    for t in frame_numbers:
        fr = reader[int(t)]
        out[int(t)] = fr if isinstance(fr, torch.Tensor) else np.asarray(fr)
    return out


def _stack_frames(images, chunk, device):
    """The frames of ``chunk`` as one [T, *S] float32 tensor on ``device``."""
    vals = [images[int(t)] for t in chunk]
    if any(isinstance(v, torch.Tensor) for v in vals):
        return torch.stack(
            [torch.as_tensor(v, dtype=torch.float32, device=device)
             for v in vals], dim=0
        )
    return torch.as_tensor(
        np.stack(vals, axis=0).astype(np.float32), device=device
    )


def _mesh_device(mesh, device, who):
    """The device of an entry point that takes ``mesh=``: ``device``, or
    the mesh's first device when only a mesh is given, else as
    ``_resolve_device``.  A ``mesh`` that is not the port's ``Mesh``
    (``parallel.sharding.make_mesh``) raises ``TypeError``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"{who}: mesh must be a clustertracking_tpu_torch Mesh "
            f"(parallel.sharding.make_mesh), not {type(mesh).__name__}")
    if mesh is not None and device is None:
        device = mesh.devices[0]
    return _resolve_device(device, who)


def _nan_trap_raise(p, rms, model, ndim):
    """Raise FloatingPointError naming the first non-finite lane of a
    dispatch (diagnostics.debug_nans), telling a model that is non-finite
    at the initial parameters from a solve that diverged."""
    bad = np.nonzero(p["valid"] & ~np.isfinite(rms))[0]
    lane = int(bad[0])
    p0 = np.asarray(p["params0"])[lane]          # [n, P]
    n, P = p0.shape
    n_extra = len(model.extra_params)
    extras = [torch.tensor(float(v)) for v in p0[0, P - n_extra:]] \
        if n_extra else []
    probe = "model probe unavailable"
    try:
        r2 = torch.linspace(0.0, 30.0, 61)
        vals = np.asarray(model.fun(r2, *extras))
        dval = np.asarray(model.dfun_dr2()(torch.tensor(1.0), *extras))
        if not np.isfinite(vals).all() or not np.isfinite(dval).all():
            first = (float(r2[~torch.from_numpy(np.isfinite(vals))][0])
                     if not np.isfinite(vals).all() else "dfun")
            probe = (
                "model.fun/dfun is NON-FINITE at the initial parameters "
                f"(first bad r2 = {first}) — fix the custom model dict "
                "(fun/dfun must be finite on r2 >= 0)"
            )
        else:
            probe = (
                "model.fun is finite at the start — the solve DIVERGED "
                "(check initial guesses, bounds, or scaling)"
            )
    except Exception as e:  # the probe is best-effort; the trap still raises
        probe = f"model probe failed: {e!r}"
    cid = int(np.asarray(p["cids"])[min(lane, len(p["cids"]) - 1)])
    t_val = p["tvals"][min(lane, len(p["tvals"]) - 1)]
    raise FloatingPointError(
        f"non-finite fit cost in dispatch: model={model.name!r} "
        f"cluster_size={p['n']} window={p['wshape']} "
        f"lanes={int(p['valid'].sum())} (first offender: cluster {cid}, "
        f"frame {t_val}, lane {lane}; {len(bad)} lane(s) affected). "
        f"{probe}. Initial params of the offending cluster "
        f"(background, signal, pos..., size..., extras...): "
        f"{np.round(p0.astype(float), 4).tolist()}. "
        "This trap is armed by clustertracking_tpu_torch.diagnostics."
        "debug_nans() / CT_TPU_DEBUG_NANS=1; without it this lane is "
        "silently rejected (cost NaN, originals kept)."
    )


def refine_leastsq(
    f: "pd.DataFrame",
    reader,
    diameter,
    separation=None,
    fit_function="gauss",
    param_mode: Optional[dict] = None,
    param_val: Optional[dict] = None,
    constraints=None,
    bounds: Optional[dict] = None,
    compute_error: bool = False,
    pos_columns: Optional[list] = None,
    t_column: str = "frame",
    max_iter: int = 10,
    max_shift: float = 1.0,
    max_rms_dev: float = 1.0,
    residual_factor: float = 1e5,
    max_cluster_size: int = 8,
    frames_per_dispatch: int = 32,
    lm_max_iter: int = 60,
    ftol: float = 1.49e-8,
    xtol: float = 1.49e-8,
    backend_find: str = "host",
    lm_backend: str = "auto",
    mesh=None,
    device=None,
) -> "pd.DataFrame":
    """Simultaneously refine overlapping features cluster-by-cluster.

    DataFrame in/out, as the reference's ``refine_leastsq``: requires
    position columns (+ optionally 'signal', 'size'/'size_*', 'frame');
    adds/updates the refined parameter columns, 'cluster',
    'cluster_size', 'cost' (NaN = rejected fit), 'fit_converged' and
    'fit_n_iter'.  Frames are stacked per ``frames_per_dispatch`` chunk
    onto ``device``, where every bucket is solved: None (the default) is
    'cuda', and raises ``RuntimeError`` where no CUDA device exists; pass
    ``device="cpu"`` to run on the host.

    ``lm_backend``: 'auto' (on CUDA, each bucket's kernel route:
    ``fused_lm_2d`` for 2D windows, ``window_gather`` then ``pixel_lm``
    for 3D and large 2D ones, ``window_gather`` then ``block_lm`` for
    unconstrained buckets of 20 slots or more, ``window_gather`` then
    ``tied_lm`` for buckets with slots tied across lanes), 'kernel'
    (force the kernel route; its plain versions on CPU) or 'torch'
    (``lm_solve`` / ``lm_solve_global``).  Dispatches are tagged by route
    (``cuda-fused``, ``cuda-gathered``, ``cuda-block``, ``cuda-tied``,
    ``cuda-torch``), those of constrained buckets with their kind too:
    ``cuda-fused-rigid``, ``cuda-torch-penalty``, ...; buckets with slots
    tied across lanes add ``-global``: ``cuda-tied-global``,
    ``cuda-tied-rigid-global`` (``cuda-torch-global`` on the plain
    route).

    A rigid constraint with ``dist_mode='global'`` (``dimer_global()``)
    fits ONE distance for the whole video: after the per-dispatch fits,
    up to three rounds of a pooled damped Newton step on that distance
    over every accepted cluster, each followed by a refit of that cluster
    size's rows with the distance fixed; the result is in
    ``out.attrs['global_dist']`` (the first such constraint) and
    ``out.attrs['global_dists']`` ({cluster_size: distance}).

    ``constraints``: ``dimer``/``trimer``/``tetramer``/``dimer_global``
    objects or reference-style ``{'type': 'eq', 'fun': f, 'args': a,
    'cluster_size': n}`` dicts (``fun`` takes torch positions [n, D]);
    a constraint built for another ndim raises ``ValueError``.

    ``mesh``: a ``Mesh`` (``parallel.sharding.make_mesh``) over whose
    shards every bucket's lanes split, padded to a multiple of
    lcm(32, mesh size); the frames go to each of its devices once, and
    ``device`` defaults to its first.  Untied buckets give every lane its
    single-device result; slots tied across lanes all-reduce across the
    shards (``_mesh_bucket_solver``).  Dispatch tags end in ``-sharded``.
    Any other ``mesh`` raises ``TypeError``.
    """
    import pandas as pd

    device = _mesh_device(mesh, device, "refine_leastsq")
    if pos_columns is None:
        pos_columns = guess_pos_columns(f)
    ndim = len(pos_columns)
    con_map = wrap_constraint_dicts(constraints, ndim)
    diameter = validate_tuple(diameter, ndim)
    radius = tuple(d / 2.0 for d in diameter)
    if separation is None:
        separation = diameter
    separation = validate_tuple(separation, ndim)
    model = get_model(fit_function)
    param_val = dict(param_val or {})

    # isotropy: explicit anisotropic size columns win
    aniso_cols = default_size_columns(ndim, False)
    isotropic = not any(c in f.columns for c in aniso_cols)
    size_cols = default_size_columns(ndim, isotropic)

    # the columns the fit reads, as arrays, once; pandas is touched again
    # only to build the output table
    def column(name):
        return f[name].to_numpy(dtype=float)

    n_rows = len(f)
    pos_all = np.stack([column(c) for c in pos_columns], axis=1)
    has_t = t_column in f.columns
    t_all = (f[t_column].to_numpy() if has_t
             else np.zeros(n_rows, dtype=np.int64))
    found = "cluster" not in f.columns
    if found:
        with diagnostics.stage("refine.find"):
            cluster, cluster_size = cluster_ids(
                pos_all, t_all if has_t else None, separation,
                backend=backend_find, device=device)
    else:
        cluster = f["cluster"].to_numpy()
        cluster_size = f["cluster_size"].to_numpy()

    # --- initial parameter table -----------------------------------------
    n_size = len(size_cols)
    extra_names = list(model.extra_params)
    P = 2 + ndim + n_size + len(extra_names)
    param_names = (
        ["background", "signal"] + pos_columns + size_cols + extra_names
    )

    if "size" in param_val:
        size_default_src = param_val["size"]
    elif isotropic:
        size_default_src = float(np.mean(radius)) / 2.0
    else:
        size_default_src = tuple(r / 2 for r in radius)
    default_size = np.asarray(
        validate_tuple(size_default_src, n_size), dtype=float
    )

    # each parameter's start: one value, or a column of the table (None:
    # the signal, read from the frame)
    starts_of = [
        param_val["background"] if "background" in param_val
        else column("background") if "background" in f.columns else 0.0,
        column("signal") if "signal" in f.columns else None,
    ] + [None] * ndim
    for j, c in enumerate(size_cols):
        # explicit param_val overrides any locate-estimated column
        if "size" in param_val:
            starts_of.append(default_size[j])
        elif c in param_val:
            starts_of.append(param_val[c])
        elif c in f.columns:
            starts_of.append(column(c))
        else:
            starts_of.append(default_size[j])
    for name in extra_names:
        if name in param_val:
            starts_of.append(param_val[name])
        elif name in f.columns:
            starts_of.append(column(name))
        else:
            starts_of.append(model.default[name])

    def initial_params(rows, images):
        """Initial parameter table for any block of feature rows (table
        positions; a whole bucket or a single spill cluster)."""
        p = np.zeros((len(rows), P))
        for j, v in enumerate(starts_of):
            if v is not None:
                p[:, j] = v[rows] if isinstance(v, np.ndarray) else v
        pos = pos_all[rows]
        p[:, 2 : 2 + ndim] = pos
        if starts_of[1] is None:
            tarr = t_all[rows]
            for t in np.unique(tarr):
                m = tarr == t
                image = np.asarray(images[int(t)].cpu()
                                   if isinstance(images[int(t)],
                                                 torch.Tensor)
                                   else images[int(t)])
                ipos = np.clip(
                    np.round(pos[m]).astype(int), 0,
                    np.asarray(image.shape) - 1,
                )
                p[m, 1] = image[tuple(ipos.T)] - p[m, 0]
        return p

    param_mode_key = tuple(sorted((param_mode or {}).items()))
    bounds_key = tuple(
        sorted((k, float(v[0]), float(v[1])) for k, v in
               (bounds or {}).items())
    )

    def _bucket_of(c):
        """A cluster size's bucket: the ladder step, except that
        constrained sizes keep exact buckets (a rigid pose needs the true
        n), a laddered bucket id must not collide with a constrained size
        (an unconstrained 5-cluster must not inherit a hexamer constraint
        by padding into bucket 6), and oversize clusters keep the true
        size for the spill path."""
        c = int(c)
        if c in con_map or c > max_cluster_size:
            return c
        lad = min(_ladder_size(c), max_cluster_size)
        return c if lad in con_map else lad

    with diagnostics.stage("refine.prepare"):
        # Column write buffers: refined values accumulate in flat numpy
        # arrays, which become the output table at the end.
        param_bufs = {}
        for name in param_names:
            if name in f.columns:
                param_bufs[name] = f[name].to_numpy(
                    dtype=np.float64).copy()
            else:
                param_bufs[name] = np.full(n_rows, np.nan)
        cost_buf = np.full(n_rows, np.nan)
        conv_buf = np.zeros(n_rows, dtype=bool)
        iter_buf = np.zeros(n_rows, dtype=np.int64)
        std_cols = {}
        if compute_error:
            for name in param_names:
                std_cols[name] = np.full(n_rows, np.nan)
        # chunks of frames_per_dispatch frames in frame order; within a
        # chunk each row's bucket (computed once per distinct cluster
        # size), and one stable sort puts every chunk's rows bucket by
        # bucket and, within a bucket, cluster by cluster
        frame_numbers, frame_rank = np.unique(t_all, return_inverse=True)
        frame_rank = frame_rank.reshape(-1)
        chunk_of = frame_rank // frames_per_dispatch
        frame_local = (frame_rank % frames_per_dispatch).astype(np.int32)
        sizes, size_rank = np.unique(cluster_size, return_inverse=True)
        bucket_of_row = np.array([_bucket_of(c) for c in sizes],
                                 dtype=np.int64)[size_rank.reshape(-1)]
        order = np.lexsort((cluster, bucket_of_row, chunk_of))
        cut = np.flatnonzero((np.diff(chunk_of[order]) != 0)
                             | (np.diff(bucket_of_row[order]) != 0)) + 1
        runs_of = [[] for _ in range(-(-len(frame_numbers)
                                         // frames_per_dispatch))]
        for rows in (np.split(order, cut) if n_rows else []):
            runs_of[chunk_of[rows[0]]].append(rows)

    in_flight: list = []
    drain_queue: list = []
    # under a mesh the lanes must split evenly over its shards
    lane_quant = _LANE_PAD if mesh is None else math.lcm(_LANE_PAD,
                                                         mesh.size)

    def _drain_bucket(p):
        """Copy one queued bucket's results to the host and write them
        back."""
        t_fetch = time.perf_counter()
        packed = p["handles"].cpu().numpy()          # ONE device fetch
        n, B, valid = p["n"], p["B"], p["valid"]
        nP = n * len(param_names)
        params_fit = packed[:, :nP].reshape(-1, n, len(param_names))
        rms = packed[:, nP]
        conv = packed[:, nP + 1] > 0.5
        iters = packed[:, nP + 2].astype(np.int64)
        std = (
            packed[:, nP + 3 :].reshape(-1, n, len(param_names))
            if compute_error else None
        )
        pos_mat = p["pos_mat"]
        ok_lane = (rms <= max_rms_dev) & np.isfinite(rms) & valid
        if diagnostics.nan_debug_active() and (
            valid & ~np.isfinite(rms)
        ).any():
            _nan_trap_raise(p, rms, model, ndim)
        diagnostics.record_batch(
            cluster_size=n,
            n_clusters=int(valid.sum()),
            n_lanes=p["Bpad"],
            n_converged=int((conv & valid).sum()),
            n_rejected=int((valid & ~ok_lane).sum()),
            mean_lm_iters=float(iters[valid].mean()) if valid.any()
            else 0.0,
            max_lm_iters=int(iters[valid].max()) if valid.any() else 0,
            mean_rms=float(rms[valid].mean()) if valid.any() else 0.0,
            wall_s=p["dispatch_s"] + (time.perf_counter() - t_fetch),
            backend=p["backend_tag"],
            solve_s=(_clock_seconds(*p["solve_marks"])
                     if "solve_marks" in p else 0.0),
            launches=p.get("launches", {}),
        )

        # vectorized writeback across the whole bucket; pos_mat slots of
        # ladder pad features are -1 and never written back
        rmsB, convB, itB = rms[:B], conv[:B], iters[:B]
        real = pos_mat >= 0                             # [B, n]
        flat_pos = pos_mat[real]
        conv_buf[flat_pos] = np.broadcast_to(
            convB[:, None], real.shape
        )[real]
        iter_buf[flat_pos] = np.broadcast_to(
            itB[:, None], real.shape
        )[real]
        ok_l = (rmsB <= max_rms_dev) & np.isfinite(rmsB)
        if ok_l.any():
            real_ok = real[ok_l]                        # [Bok, n]
            okpos = pos_mat[ok_l][real_ok]
            pf = params_fit[:B][ok_l]                   # [Bok, n, P]
            for j, name in enumerate(param_names):
                param_bufs[name][okpos] = pf[:, :, j][real_ok]
            cost_buf[okpos] = np.broadcast_to(
                rmsB[ok_l][:, None], real_ok.shape
            )[real_ok]
            if compute_error:
                stdok = std[:B][ok_l]
                for j, name in enumerate(param_names):
                    std_cols[name][okpos] = stdok[:, :, j][real_ok]
        # rejected: keep originals, cost stays NaN

    def _prepare_bucket(n, rows, images, frame_shape, stack):
        """One bucket of a chunk made ready for its solver: ``(solver, its
        arguments on the device, the dispatch's record)``, or None where
        its clusters spilled to the host scipy path.  ``rows``: the
        bucket's table positions, sorted by cluster id (stably), so every
        cluster is a contiguous block and the whole bucket assembles with
        vectorized numpy."""
        cid = cluster[rows]
        boundaries = np.nonzero(np.diff(cid))[0] + 1
        if n > max_cluster_size:
            _spill_scipy(
                param_bufs, cost_buf, np.split(rows, boundaries), images,
                model, ndim, isotropic, radius, separation,
                param_names, initial_params, t_all, max_iter, max_shift,
                max_rms_dev, param_mode_key, conv_buf, iter_buf,
                std_cols if compute_error else None,
            )
            return None

        # integrity guard for user-supplied cluster columns: every
        # cluster id must appear exactly cluster_size times, within
        # one frame
        starts = np.concatenate([[0], boundaries])
        sizes_arr = np.diff(np.concatenate([starts, [len(rows)]]))
        csz_first = cluster_size[rows[starts]]
        t_arr = t_all[rows]
        if (
            (sizes_arr != csz_first).any()
            or (sizes_arr > n).any()
            or (t_arr != np.repeat(t_arr[starts], sizes_arr)).any()
        ):
            raise ValueError(
                "inconsistent cluster/cluster_size columns: a cluster "
                "id appears with the wrong multiplicity or spans "
                "frames — re-run find_clusters"
            )
        B = len(starts)
        Bpad = max(lane_quant,
                   int(np.ceil(B / lane_quant)) * lane_quant)
        flat = initial_params(rows, images)         # [rows, P]
        params0 = np.zeros((Bpad, n, P), dtype=np.float32)
        # pad features replicate member 0 (keeps bbox/window geometry
        # intact) with signal 0; fvalid gates them out of the model,
        # the Jacobian and the mask entirely
        params0[:B] = np.repeat(flat[starts], n, axis=0).reshape(
            B, n, P
        )
        params0[:B, :, 1] = 0.0
        within = np.arange(len(rows)) - np.repeat(starts, sizes_arr)
        slot_flat = np.repeat(np.arange(B), sizes_arr) * n + within
        params0[:B].reshape(-1, P)[slot_flat] = flat
        fval = np.zeros((Bpad, n), dtype=np.float32)
        fval.reshape(-1)[slot_flat] = 1.0
        fidx = np.zeros(Bpad, dtype=np.int32)
        fidx[:B] = frame_local[rows[starts]]
        valid = np.zeros(Bpad, dtype=bool)
        valid[:B] = True
        pos_mat = np.full((B, n), -1, dtype=np.int64)
        pos_mat.reshape(-1)[slot_flat] = rows
        # pad lanes replicate lane 0 (keeps shapes sane numerically)
        if B < Bpad and B > 0:
            params0[B:] = params0[0]
            fval[B:] = fval[0]

        wshape = _window_shape(n, ndim, radius, separation, frame_shape)
        if n > 1:
            # Shrink to this batch's ACTUAL cluster bounding box (the
            # static formula assumes a straight chain), quantized to
            # multiples of 8 so window shapes stay few.
            posb = params0[:B, :, 2 : 2 + ndim]
            ext = (posb.max(axis=1) - posb.min(axis=1)).max(axis=0)
            margin = 2.0 * max_shift + 3.0
            dyn = tuple(
                min(
                    w,
                    max(8, int(-(-(e + 2 * r + margin) // 8) * 8)),
                )
                for w, e, r in zip(wshape, ext, radius)
            )
            wshape = tuple(
                min(d, s) for d, s in zip(dyn, frame_shape)
            )
        con = con_map.get(n)
        bucket_args = (
            model, ndim, isotropic, n, param_mode_key, wshape,
            radius, bounds_key, con, residual_factor,
            max_iter, max_shift, lm_max_iter, ftol, xtol,
            compute_error, lm_backend,
        )
        if mesh is None:
            solver, _ = _bucket_solver(*bucket_args)
            route_on = _shard_solver(*bucket_args)[3]
            backend_tag = route_on(device).tag
        else:
            solver, _, backend_tag = _mesh_bucket_solver(mesh, *bucket_args)
        if con is not None and con.kind == "rigid":
            pose0 = positions_to_pose(params0[:, :, 2:2 + ndim], con)
        else:
            pose0 = np.zeros((Bpad, 0))
        args = (
            stack, torch.as_tensor(fidx, device=device),
            torch.as_tensor(params0, device=device),
            torch.as_tensor(pose0, dtype=torch.float32, device=device),
            torch.as_tensor(valid, device=device),
            None if con is not None
            else torch.as_tensor(fval, device=device),
        )
        return solver, args, dict(
            n=n, B=B, Bpad=Bpad, valid=valid, pos_mat=pos_mat,
            wshape=wshape, backend_tag=backend_tag,
            # non-finite trap context (diagnostics.debug_nans)
            params0=params0, cids=cid[starts], tvals=t_arr[starts],
        )

    for k, chunk_start in enumerate(
            range(0, len(frame_numbers), frames_per_dispatch)):
        chunk = frame_numbers[chunk_start : chunk_start + frames_per_dispatch]
        with diagnostics.stage("refine.prepare"):
            images = _frames_of(reader, chunk, ndim)
            frame_shape = tuple(images[int(chunk[0])].shape)
            stack = _stack_frames(images, chunk, device)
        for rows in runs_of[k]:
            with diagnostics.stage("refine.prepare"):
                bucket = _prepare_bucket(int(bucket_of_row[rows[0]]), rows,
                                         images, frame_shape, stack)
            if bucket is None:
                continue
            solver, args, p = bucket
            collecting = diagnostics.collecting()
            if collecting:
                launches0 = _launch_counts()
                mark0 = _clock_mark(device)
            t_dispatch = time.perf_counter()
            outs = solver(*args)
            with diagnostics.stage("solver.finish"):
                p["handles"] = _pack_results(*outs, compute_error)
            p["dispatch_s"] = time.perf_counter() - t_dispatch
            if collecting:
                p["solve_marks"] = (mark0, _clock_mark(device))
                p["launches"] = _launches_since(launches0)
            in_flight.append(p)

        # keep at most one chunk's dispatches in flight (bounds device
        # memory: two chunks' frame stacks + results live at once)
        if drain_queue:
            with diagnostics.stage("refine.drain"):
                for p in drain_queue:
                    _drain_bucket(p)
        drain_queue = in_flight
        in_flight = []

    with diagnostics.stage("refine.drain"):
        for p in drain_queue:
            _drain_bucket(p)

        # the output in one construction: the input's columns, those
        # this call sets replaced in place and the new ones after them,
        # in the order column assignments would give
        columns = {c: f[c].array for c in f.columns}
        if found:
            columns["cluster"] = cluster
            columns["cluster_size"] = cluster_size
        if not has_t:
            columns[t_column] = t_all
        columns.update(param_bufs)
        columns["cost"] = cost_buf
        columns["fit_converged"] = conv_buf
        columns["fit_n_iter"] = iter_buf
        for name, col in std_cols.items():
            columns[name + "_std"] = col
        out = pd.DataFrame(columns, index=f.index)
        if (out.columns.dtype != f.columns.dtype
                or f.columns.name is not None):
            # the labels typed and named as inserting them one by one
            # into the input's would
            labels = f.columns
            for c in columns:
                if c not in f.columns:
                    labels = labels.insert(len(labels), c)
            out.columns = labels
        out.attrs = copy.deepcopy(f.attrs)

    gcons = [c for c in con_map.values() if _global_distance(c)]
    if gcons:
        refreshed = list(param_names) + [
            "cost", "fit_converged", "fit_n_iter"]
        if compute_error:
            refreshed += [name + "_std" for name in param_names]
        global_dists = {}
        for gcon in gcons:
            n = gcon.cluster_size
            d_prev = None
            for _ in range(3):
                acc = out[(out["cluster_size"] == n) & out["cost"].notna()]
                if not len(acc):
                    break
                # the start: the mean distance within each cluster, its
                # rows grouped by cluster first.  (Rows need not come in
                # cluster order — locate's come brightest first — and the
                # reference reshapes them as they come,
                # clustertracking_tpu/refine.py:1603, starting from the
                # distance between unrelated features; ROADMAP queue 3.)
                posf = acc.sort_values("cluster", kind="stable")[
                    pos_columns].to_numpy(dtype=float).reshape(-1, n, ndim)
                rel = posf - posf.mean(axis=1, keepdims=True)
                d0 = float(np.linalg.norm(rel, axis=-1).mean()
                           / circumradius_factor(n, ndim))
                d_star = _joint_global_dist(
                    acc, reader, n, model, ndim, isotropic, radius,
                    separation, param_names, t_column, frames_per_dispatch,
                    d0, device)
                if d_star is None:
                    break
                converged = d_prev is not None and (
                    abs(d_star - d_prev) <= 1e-4 * max(d_star, 1e-6))
                d_prev = d_star
                if converged:
                    break
                # refit only this cluster size's rows, the distance fixed
                fixed = [dataclasses.replace(c, dist=float(d_star))
                         if c is gcon else c for c in con_map.values()]
                sub_mask = out["cluster_size"] == n
                sub = refine_leastsq(
                    out[sub_mask], reader, diameter, separation,
                    fit_function=model, param_mode=param_mode,
                    param_val=param_val, constraints=fixed, bounds=bounds,
                    compute_error=compute_error, pos_columns=pos_columns,
                    t_column=t_column, max_iter=max_iter,
                    max_shift=max_shift, max_rms_dev=max_rms_dev,
                    residual_factor=residual_factor,
                    max_cluster_size=max_cluster_size,
                    frames_per_dispatch=frames_per_dispatch,
                    lm_max_iter=lm_max_iter, ftol=ftol, xtol=xtol,
                    backend_find=backend_find, lm_backend=lm_backend,
                    mesh=mesh, device=device,
                )
                for col in refreshed:
                    if col in sub.columns:
                        out.loc[sub_mask, col] = sub[col]
            if d_prev is not None:
                global_dists[int(n)] = float(d_prev)
        if global_dists:
            out.attrs["global_dist"] = next(iter(global_dists.values()))
            out.attrs["global_dists"] = global_dists
    return out


def _dist_eq(model, ndim, isotropic, n, window_shape, radius, device):
    """The pooled normal equations of a shared rigid distance over one
    bucket: ``accum(frames, frame_idx, params_fit, valid, d) -> (H, g,
    cost)`` of the unnormalized residual with respect to the scalar ``d``,
    with positions ``center + circ·d·u_i`` (u_i the unit offsets of each
    fitted cluster) and the pixels and mask held at the fitted geometry.
    The derivative is forward-mode (``torch.func.jvp``)."""
    layout = build_layout(model, ndim, isotropic, n, {})
    fns = make_model_fns(model, layout, window_shape, device=device)
    pos_idx = list(layout.pos_param_idx)
    p0 = pos_idx[0]  # positions are the ndim params after signal
    circ = float(circumradius_factor(n, ndim))

    def accum(frames, frame_idx, params_fit, valid, d):
        pos = params_fit[..., pos_idx]                  # [B, n, D]
        center = pos.mean(dim=1, keepdim=True)
        rel = pos - center
        u = rel / torch.clamp(torch.linalg.norm(rel, dim=-1, keepdim=True),
                              min=1e-9)
        origin = origins_for(pos, window_shape, tuple(frames.shape[1:]))
        pixels = window_gather(frames, frame_idx, origin, window_shape)
        mask = radius_mask(pos, origin, window_shape, radius)

        def resid(dv):
            newpos = center + circ * dv * u
            params = torch.cat([params_fit[..., :p0], newpos,
                                params_fit[..., p0 + ndim:]], dim=-1)
            img = fns.image_from_params(params, origin)
            return (img - pixels) * mask

        r, dr = torch.func.jvp(resid, (d,), (torch.ones_like(d),))
        w = valid.to(r.dtype)[:, None]
        return (torch.sum(dr * dr * w), torch.sum(dr * r * w),
                torch.sum(r * r * w))

    return accum


def _pooled_buckets(rows, reader, ndim, radius, separation, param_names,
                    t_column, frames_per_dispatch, make_accum, device):
    """(accum, args) per (frame chunk × cluster size) of ``rows``, for a
    step on normal equations pooled over a whole video:
    ``make_accum(n, window_shape)`` builds one cluster size's
    accumulator, and ``args = (frames, frame_idx, params, valid)`` (lanes
    padded to ``_LANE_PAD``) stay on ``device``, so a trial value of the
    shared quantity moves only that value."""
    frame_numbers = sorted(rows[t_column].unique())
    buckets = []
    P = len(param_names)
    for cs in range(0, len(frame_numbers), frames_per_dispatch):
        chunk = frame_numbers[cs : cs + frames_per_dispatch]
        images = _frames_of(reader, chunk, ndim)
        frame_shape = tuple(images[int(chunk[0])].shape)
        stack = _stack_frames(images, chunk, device)
        frame_local = {int(t): i for i, t in enumerate(chunk)}
        sub = rows[rows[t_column].isin(chunk)]
        for n, grp in sub.groupby("cluster_size"):
            n = int(n)
            grp = grp.sort_values("cluster", kind="stable")
            if len(grp) % n != 0:
                continue  # inconsistent block (refine guards upstream)
            B = len(grp) // n
            flat = np.zeros((len(grp), P), np.float32)
            for j, name in enumerate(param_names):
                flat[:, j] = grp[name].to_numpy(dtype=float)
            Bpad = max(_LANE_PAD, -(-B // _LANE_PAD) * _LANE_PAD)
            params = np.zeros((Bpad, n, P), np.float32)
            params[:B] = flat.reshape(B, n, P)
            params[B:] = params[0]
            fidx = np.zeros(Bpad, np.int32)
            fidx[:B] = [frame_local[int(t)] for t in
                        grp[t_column].to_numpy().reshape(B, n)[:, 0]]
            valid = np.zeros(Bpad, bool)
            valid[:B] = True
            wshape = _window_shape(n, ndim, radius, separation, frame_shape)
            buckets.append((make_accum(n, wshape), (
                stack, torch.as_tensor(fidx, device=device),
                torch.as_tensor(params, device=device),
                torch.as_tensor(valid, device=device))))
    return buckets


def _pooled_eq(buckets, x):
    """The pooled normal equations ``(H, g, cost)`` at the shared value
    ``x``: every bucket's sums at ``x`` (float32, on the buckets' device),
    added in float64 on the host after one transfer."""
    device = buckets[0][1][0].device
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    parts = [accum(*args, xt) for accum, args in buckets]
    per = torch.stack([torch.cat([t.reshape(-1) for t in p])
                       for p in parts]).cpu().numpy()
    tot = np.zeros(per.shape[1])
    for row in per.astype(np.float64):
        tot += row
    H, g, cost = np.split(tot, np.cumsum([t.numel() for t in parts[0]])[:-1])
    return (H.reshape(parts[0][0].shape), g.reshape(parts[0][1].shape),
            float(cost[0]))


def _joint_global_dist(acc, reader, n, model, ndim, isotropic, radius,
                       separation, param_names, t_column,
                       frames_per_dispatch, d0, device):
    """One video-wide rigid distance for the accepted ``n``-clusters in
    ``acc``: damped Newton from ``d0`` on the normal equations pooled over
    every dispatch (``_dist_eq``, ``_pooled_eq``)."""
    buckets = _pooled_buckets(
        acc, reader, ndim, radius, separation, param_names, t_column,
        frames_per_dispatch,
        lambda n, wshape: _dist_eq(model, ndim, isotropic, n, wshape,
                                   tuple(radius), device),
        device)
    if not buckets:
        return None

    def eval_at(dv):
        return tuple(float(v) for v in _pooled_eq(buckets, dv))

    d = float(d0)
    Hx, gx, cx = eval_at(d)
    lam = 1e-3
    for _ in range(25):
        delta = -gx / max(Hx * (1.0 + lam), 1e-12)
        dt = max(d + delta, 1e-3)
        Ht, gt, ct_ = eval_at(dt)
        if ct_ < cx:
            moved = abs(dt - d)
            d, Hx, gx, cx = dt, Ht, gt, ct_
            lam = max(lam * 0.25, 1e-8)
            if moved < 1e-5 * max(abs(d), 1e-6):
                break
        else:
            lam *= 4.0
            if lam > 1e10:
                break
    return d


def _host_profile(model):
    """The hostref profile for a model: builtin names resolve to numpy
    profiles with analytic Jacobians; a custom torch ``fun`` is wrapped to
    take and return numpy (scipy then finite-differences it)."""
    if model.name in ("gauss", "ring", "hat", "disc") or \
            model.name.startswith("inv_series_"):
        return model.name

    def profile(r2, *extras):
        t = [torch.as_tensor(np.asarray(a, np.float64)) for a in
             (r2,) + extras]
        return model.fun(*t).numpy()

    return profile


def _spill_scipy(
    param_bufs, cost_buf, row_groups, images, model, ndim, isotropic,
    radius, separation, param_names, initial_params, t_all, max_iter,
    max_shift, max_rms_dev, param_mode_key, conv_buf=None, iter_buf=None,
    std_cols=None,
):
    """Host scipy path for clusters larger than the biggest bucket (each
    of ``row_groups`` one cluster's table positions, ``t_all`` the frame
    of every row); sets ``fit_converged``/``fit_n_iter`` from scipy's
    ier/nfev and fills the ``_std`` columns from the leastsq covariance
    when requested."""
    from .hostref import fit_cluster_scipy

    t_dispatch = time.perf_counter()
    n_rej = 0
    profile = _host_profile(model)
    for pos in row_groups:
        n = len(pos)
        t = int(t_all[pos[0]])
        image = images[t]
        image = np.asarray(image.cpu() if isinstance(image, torch.Tensor)
                           else image)
        p0 = initial_params(pos, images)
        layout = build_layout(
            model, ndim, isotropic, n, dict(param_mode_key)
        )
        wshape = _window_shape(n, ndim, radius, separation, image.shape)
        norm = max(np.abs(p0[:, 1]).max(), 1e-6)
        params, rms, _, info = fit_cluster_scipy(
            image, p0, layout.slot_idx, wshape, radius, isotropic,
            profile=profile,
            norm=norm, max_iter_refit=max_iter, max_shift=max_shift,
            full_output=True,
            # bound the worst case: a non-converging oversized chain may
            # otherwise re-enter leastsq max_iter times
            nfev_budget=min(50 * (layout.n_slots + 1), 20000),
        )
        if conv_buf is not None:
            conv_buf[pos] = info["converged"]
        if iter_buf is not None:
            iter_buf[pos] = info["nfev"]
        if rms <= max_rms_dev and np.isfinite(rms):
            for j, name in enumerate(param_names):
                param_bufs[name][pos] = params[:, j]
            cost_buf[pos] = float(rms)
            if std_cols is not None:
                for j, name in enumerate(param_names):
                    std_cols[name][pos] = info["std"][:, j]
        else:
            n_rej += 1
    if row_groups:
        solve_s = time.perf_counter() - t_dispatch
        diagnostics.record_batch(
            cluster_size=len(row_groups[0]),
            n_clusters=len(row_groups),
            n_lanes=len(row_groups),
            n_converged=len(row_groups) - n_rej,
            n_rejected=n_rej,
            mean_lm_iters=0.0,
            max_lm_iters=0,
            mean_rms=0.0,
            wall_s=solve_s,
            backend="scipy",
            solve_s=solve_s,
        )


# train_leastsq lives in train.py, which imports this module's bucket
# machinery; the import sits at the bottom to avoid a cycle.
from .train import train_leastsq  # noqa: E402
