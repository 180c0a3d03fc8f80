"""refine_leastsq — the core fitting pipeline, in PyTorch.

Counterpart of ``clustertracking_tpu/refine.py``.  Clusters are bucketed
by cluster size; each bucket becomes one batched solve that fits every
cluster of the bucket together:

- window gather, fit-region mask, parameter packing, LM solve and the
  refit-on-shift outer loop (``max_iter``/``max_shift``) all run on the
  device that holds the frames; on CUDA each bucket takes the kernel route
  ``ops/fused_lm.py::kernel_route`` names: 'fused' (2D windows,
  ``csrc/fused_lm_2d.cu``), 'gathered' (3D and large 2D windows,
  ``csrc/window_gather.cu`` then ``csrc/pixel_lm.cu``, once per refit
  round) or none (``ops/lm.py::lm_solve``);
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
  tie their slots across each dispatch's lanes through
  ``ops/lm.py::lm_solve_global``, on the device of the frames (no kernel
  takes a tied slot, as in the reference); a rigid distance tied across
  every cluster (``dimer_global()``'s default) alternates a pooled Newton
  step on the whole video's distance with a refit at that distance fixed
  (``_joint_global_dist``), and reports it in ``out.attrs``.

Rows without a 'cluster' column are grouped by ``find_clusters``
(``backend_find``: 'host', 'auto' or 'device', on the same device).
``mesh=`` (a ``parallel.sharding.make_mesh`` mesh) splits every bucket's
lanes over several devices (``_mesh_bucket_solver``).  pandas is
imported by the DataFrame entry points only.  ``train_leastsq``
(train.py) is exported from here too, as in the reference.
"""
from __future__ import annotations

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
from .find import find_clusters
from .models.packing import build_layout
from .models.registry import ModelSpec, get_model
from .ops.collectives import Mesh, join_lanes, split_lanes
from .ops.fused_lm import fused_lm_2d, kernel_route
from .ops.gather import gather_stack, origins_for, radius_mask
from .ops.lm import GlobalShard, lm_solve, lm_solve_global_shards
from .ops.pixel_lm import pixel_lm
from .ops.residual import make_model_fns
from .ops.rigid import make_constrained_fns
from .ops.window_gather import window_gather
from .utils import default_size_columns, guess_pos_columns, validate_tuple

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["refine_leastsq", "train_leastsq"]

_LANE_PAD = 32  # lanes are padded to multiples of this (reference parity)

_LM_BACKENDS = ("auto", "kernel", "torch")
_GATHER_BACKENDS = ("auto", "torch")


def _route_taken(lm_backend, route, device):
    """The route a bucket's solve takes: 'fused', 'gathered' or 'torch'.

    'auto' takes the bucket's kernel route (``kernel_route``) on CUDA;
    'kernel' forces it (its plain versions on CPU); 'torch' forces
    lm_solve."""
    if lm_backend == "kernel" or (lm_backend == "auto" and route is not None
                                  and device.type == "cuda"):
        return route
    return "torch"


def _slot_bounds(layout, window_shape, frame_shape, bounds_key=(),
                 constraint=None):
    """Per-slot f32 (lo, hi) of the optimizer vector: the user's
    ``bounds`` (name, lo, hi) tuples plus the implicit ones — positions
    stay inside the frame (a lane whose gradient vanishes cannot
    random-walk away) and sizes stay in [0.05, largest window extent] (a
    size through zero makes r² = 0/0).

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
    return lo, hi


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

    Returns ``(solve_shards, layout, use_global, route)``:
    ``solve_shards`` takes a list of per-shard argument tuples (those of
    ``_bucket_solver``'s ``solve``, each on its shard's device) and
    returns one output tuple per shard; ``use_global`` says whether the
    bucket ties slots across lanes, ``route`` is ``kernel_route``'s pick.
    ``residual_factor`` weighs a generic constraint's penalty rows (by
    its square root).

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
    route = kernel_route(model, layout, use_global, constraint, window_shape)
    if lm_backend == "kernel" and route is None:
        raise ValueError(
            "lm_backend='kernel' unsupported for this configuration "
            f"(V={layout.n_slots} slots, window {window_shape}, "
            f"constraint {getattr(constraint, 'name', None)!r}, "
            f"global-tied slots {use_global})"
        )
    if use_global:
        # the slots tied across lanes, over the solve's vector: a rigid
        # bucket's is [pose, distance, std slots], so a shared distance is
        # slot Qt - 1 and the model's slots follow at Qt + s
        Qt = (pose_dim(constraint) + int(constraint.fit_dist)
              if constraint is not None and constraint.kind == "rigid"
              else 0)
        gslots = np.zeros(Qt + layout.n_slots, dtype=bool)
        if _global_distance(constraint):
            gslots[Qt - 1] = True
        gslots[Qt:] = layout.global_slots

    def setup(frames, frame_idx, params0, pose0, valid, fvalid=None):
        """One shard's (or the whole bucket's) solve state, on the device
        of ``frames``."""
        sh = types.SimpleNamespace(
            frames=frames, frame_idx=frame_idx, params0=params0,
            valid=valid, device=frames.device, B=params0.shape[0],
            frame_shape=tuple(frames.shape[1:]))
        device = sh.device
        sh.taken = _route_taken(lm_backend, route, device)
        signal0 = params0[..., layout.signal_param_idx]
        sh.norm = torch.clamp(torch.amax(torch.abs(signal0), dim=1),
                              min=1e-6)
        sh.lo_np, sh.hi_np = _slot_bounds(layout, window_shape,
                                          sh.frame_shape, bounds_key,
                                          constraint)
        sh.lo_b = torch.as_tensor(sh.lo_np, device=device)
        sh.hi_b = torch.as_tensor(sh.hi_np, device=device)
        if constraint is None:
            fns = make_model_fns(model, layout, window_shape, device=device)
            sh.residual, sh.residual_jac = fns.residual, fns.residual_jac
            sh.vect0 = layout.vect_from_params(params0)
            sh.Qt = 0

            def positions_of(vect):
                return layout.vect_to_params(vect, params0)[..., pos_idx]

            def params_of(vect):
                return layout.vect_to_params(vect, params0)
        else:
            # constrained buckets are exact-size: no pad features to gate
            fvalid = None
            cfns = make_constrained_fns(model, layout, window_shape,
                                        constraint, residual_factor, device)
            sh.residual, sh.residual_jac = cfns.residual, cfns.residual_jac
            sh.vect0 = cfns.vect_of(params0, pose0.to(params0.dtype))
            sh.Qt = cfns.Qt

            def positions_of(vect):
                return cfns.positions_of(vect, params0)

            def params_of(vect):
                return cfns.params_of(vect, params0)
        sh.positions_of, sh.params_of = positions_of, params_of
        sh.fvalid = fvalid
        sh.fv_extra = () if fvalid is None else (fvalid,)
        return sh

    def window_of(sh, vect):
        """(positions, window origins) at ``vect``."""
        pos_at = sh.positions_of(vect).contiguous()
        return pos_at, origins_for(pos_at, window_shape, sh.frame_shape)

    def solve_round(sh, vect, need):
        """One refit round of an untied bucket on its own device."""
        pos_at, origin = window_of(sh, vect)
        kw = dict(model=model, layout=layout,
                  window_shape=window_shape, lo=sh.lo_np, hi=sh.hi_np,
                  radius=radius, max_iter=lm_max_iter, ftol=ftol,
                  xtol=xtol, constraint=constraint)
        frames, frame_idx, params0 = sh.frames, sh.frame_idx, sh.params0
        if sh.taken == "fused":
            res = fused_lm_2d(vect, params0, frames, frame_idx, pos_at,
                              origin, sh.norm, need, sh.fvalid, **kw)
        elif sh.taken == "gathered":
            pixels = gather(frames, frame_idx, origin, window_shape)
            res = pixel_lm(vect, params0, pixels, pos_at, origin, sh.norm,
                           need, sh.fvalid, streaming=streaming, **kw)
        else:
            pixels = gather(frames, frame_idx, origin, window_shape)
            mask = radius_mask(pos_at, origin, window_shape, radius,
                               fvalid=sh.fvalid)
            res = lm_solve(
                sh.residual, sh.residual_jac, vect,
                (params0, pixels, mask, origin, sh.norm) + sh.fv_extra,
                max_iter=lm_max_iter, ftol=ftol, xtol=xtol,
                lower=sh.lo_b, upper=sh.hi_b, valid=need,
            )._replace(npix=mask.sum(dim=1))
        return res, pos_at

    def tied_round(shs, vects, needs):
        """One refit round of a tied bucket: ONE joint lm_solve_global over
        every shard's lanes, the windows gathered on each shard's
        device."""
        pos_ats, masks, parts = [], [], []
        for sh, vect, need in zip(shs, vects, needs):
            pos_at, origin = window_of(sh, vect)
            pixels = gather(sh.frames, sh.frame_idx, origin, window_shape)
            mask = radius_mask(pos_at, origin, window_shape, radius,
                               fvalid=sh.fvalid)
            parts.append(GlobalShard(
                sh.residual, sh.residual_jac, vect,
                (sh.params0, pixels, mask, origin, sh.norm) + sh.fv_extra,
                sh.lo_b, sh.hi_b, need))
            pos_ats.append(pos_at)
            masks.append(mask)
        results = lm_solve_global_shards(
            parts, gslots, max_iter=lm_max_iter, ftol=ftol, xtol=xtol)
        return [(res._replace(npix=mask.sum(dim=1)), pos_at)
                for res, mask, pos_at in zip(results, masks, pos_ats)]

    def finish(sh, vect_best, rms_best, conv_best, iters):
        """The outputs of one shard, with ``compute_error``'s std."""
        device, params0, fvalid = sh.device, sh.params0, sh.fvalid
        params = sh.params_of(vect_best)
        if not compute_error:
            return (params, rms_best, conv_best, iters,
                    torch.zeros((0,), device=device))
        pos = sh.positions_of(vect_best)
        origin = origins_for(pos, window_shape, sh.frame_shape)
        pixels = gather(sh.frames, sh.frame_idx, origin, window_shape)
        mask = radius_mask(pos, origin, window_shape, radius, fvalid=fvalid)
        r, J = sh.residual_jac(
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
            lambda v: sh.positions_of(v[None])[0]))(vect_best)  # [B,n,D,Vc]
        var_pos = torch.einsum("bndu,buv,bndv->bnd", G, cov, G) \
            * sigma2[:, None, None]
        std_params = layout.vect_to_params(std_vect[:, sh.Qt:], nan_params)
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
        an untied bucket's rounds are each shard's own."""
        shs = [setup(*a) for a in shard_args]
        # Refit-on-shift: a lane whose positions moved more than max_shift
        # is re-gathered around its new positions and solved again.  The
        # next round starts from the latest iterate, but the REPORTED fit
        # is each lane's best finite round (re-centering changes the data
        # a lane is fit against, and a later round can be worse).
        vect = [sh.vect0 for sh in shs]
        need = [sh.valid for sh in shs]
        iters = [torch.zeros((sh.B,), dtype=torch.int32, device=sh.device)
                 for sh in shs]
        vect_best = list(vect)
        rms_best = [torch.full((sh.B,), torch.inf, device=sh.device)
                    for sh in shs]
        conv_best = [torch.zeros((sh.B,), dtype=torch.bool, device=sh.device)
                     for sh in shs]
        for it in range(max(max_iter, 1)):
            if it > 0 and not any(bool(nd.any()) for nd in need):
                break
            with diagnostics.stage(f"refit_round_{it}"):
                if use_global:
                    rounds = tied_round(shs, vect, need)
                else:
                    rounds = [solve_round(sh, v, nd)
                              for sh, v, nd in zip(shs, vect, need)]
            for s, (sh, (res, pos_at)) in enumerate(zip(shs, rounds)):
                shift = torch.amax(
                    torch.abs(sh.positions_of(res.x) - pos_at), dim=(1, 2)
                )
                npx_raw = res.npix
                npx = torch.clamp(npx_raw, min=1.0)
                # an empty fit mask (every feature outside its window) has
                # residual ≡ 0 — that is a FAILED fit, not a perfect one
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
        return [finish(*a) for a in zip(shs, vect_best, rms_best, conv_best,
                                         iters)]

    return solve_shards, layout, use_global, route


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
      reference.

    Returns ``(call, layout, backend_tag)``: ``call`` takes and returns
    what the single-device solver does, its outputs joined in lane order
    on the mesh's first device; the tag is the single-device one with
    ``-sharded`` appended (``cuda-fused-sharded``,
    ``cuda-torch-global-sharded``, ...)."""
    solve_shards, layout, use_global, route = _shard_solver(
        model, ndim, isotropic, n, param_mode_key, window_shape, radius,
        bounds_key, constraint, residual_factor, max_iter, max_shift,
        lm_max_iter, ftol, xtol, compute_error, lm_backend, gather_backend,
        streaming)
    dev0 = mesh.devices[0]
    backend_tag = _backend_tag(lm_backend, route, use_global, constraint,
                               dev0) + "-sharded"

    def call(stack, fidx, params0, pose0, valid, fvalid=None):
        lanes = [None if a is None else torch.as_tensor(a)
                 for a in (fidx, params0, pose0, valid, fvalid)]
        shards = split_lanes(
            mesh, lanes, shared=(torch.as_tensor(stack, dtype=torch.float32),))
        if use_global:   # one lockstep loop, its ties across every shard
            outs = solve_shards(shards)
        else:            # each shard's own loop
            outs = [solve_shards([a])[0] for a in shards]
        joined = [join_lanes(parts, dev0) for parts in zip(*outs)]
        if not compute_error:   # the std placeholder has no lanes
            joined[4] = outs[0][4].to(dev0)
        return tuple(joined)

    return call, layout, backend_tag


def _backend_tag(lm_backend, route, use_global, constraint, device):
    """A dispatch's ``diagnostics`` tag: the device type, the route taken
    (``fused``, ``gathered``, ``torch``), ``-rigid`` / ``-penalty`` for a
    constrained bucket and ``-global`` for a tied one."""
    kind = "" if constraint is None else (
        "-rigid" if constraint.kind == "rigid" else "-penalty")
    kind += "-global" if use_global else ""
    return (f"{device.type}-{_route_taken(lm_backend, route, device)}"
            f"{kind}")


def _global_distance(constraint) -> bool:
    """A rigid constraint whose fitted distance is one for every cluster."""
    return (constraint is not None and constraint.kind == "rigid"
            and constraint.fit_dist and constraint.dist_mode == "global")


def _uses_global(layout, constraint) -> bool:
    """A bucket with slots tied across lanes: 'global' parameter modes or a
    globally shared rigid distance (solved by ``lm_solve_global``)."""
    return bool(np.any(layout.global_slots) or _global_distance(constraint))


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


def _resolve_device(device, who):
    """``device``, or 'cuda' when it is None; raises ``RuntimeError`` where
    no CUDA device exists and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device is available; it runs on the GPU "
                "unless device='cpu' is passed"
            )
        device = "cuda"
    return torch.device(device)


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
    for 3D and large 2D ones), 'kernel' (force the kernel route; its plain
    versions on CPU) or 'torch' (``lm_solve``).  Dispatches of constrained
    buckets are tagged with their kind: ``cuda-fused-rigid``,
    ``cuda-torch-penalty``, ...; buckets with slots tied across lanes
    (``lm_solve_global``) add ``-global``: ``cuda-torch-global``,
    ``cuda-torch-rigid-global``.

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

    f = f.copy()
    if "cluster" not in f.columns:
        f = find_clusters(
            f, separation, pos_columns, t_column, backend=backend_find,
            device=device,
        )
    if t_column not in f.columns:
        f[t_column] = 0

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

    def initial_params(rows, images):
        """Initial parameter table for any block of feature rows (a whole
        bucket or a single spill cluster)."""
        k = len(rows)
        p = np.zeros((k, P))
        p[:, 0] = param_val.get(
            "background",
            rows["background"].to_numpy() if "background" in rows
            else 0.0,
        )
        pos = rows[pos_columns].to_numpy(dtype=float)
        p[:, 2 : 2 + ndim] = pos
        if "signal" in rows:
            p[:, 1] = rows["signal"].to_numpy(dtype=float)
        else:
            tarr = rows[t_column].to_numpy()
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
        for j, c in enumerate(size_cols):
            # explicit param_val overrides any locate-estimated column
            if "size" in param_val or c in param_val:
                p[:, 2 + ndim + j] = default_size[j] \
                    if "size" in param_val else param_val[c]
            elif c in rows:
                p[:, 2 + ndim + j] = rows[c].to_numpy(dtype=float)
            else:
                p[:, 2 + ndim + j] = default_size[j]
        for j, name in enumerate(extra_names):
            if name in param_val:
                p[:, 2 + ndim + n_size + j] = param_val[name]
            elif name in rows:
                p[:, 2 + ndim + n_size + j] = rows[name].to_numpy(
                    dtype=float
                )
            else:
                p[:, 2 + ndim + n_size + j] = model.default[name]
        return p

    param_mode_key = tuple(sorted((param_mode or {}).items()))
    bounds_key = tuple(
        sorted((k, float(v[0]), float(v[1])) for k, v in
               (bounds or {}).items())
    )

    import pandas as pd

    out = f.copy()
    # Column write buffers: refined values accumulate in flat numpy arrays
    # and are assigned to the DataFrame once at the end.
    param_bufs = {}
    for name in param_names:
        if name in out.columns:
            param_bufs[name] = out[name].to_numpy(dtype=np.float64).copy()
        else:
            param_bufs[name] = np.full(len(out), np.nan)
    cost_buf = np.full(len(out), np.nan)
    conv_buf = np.zeros(len(out), dtype=bool)
    iter_buf = np.zeros(len(out), dtype=np.int64)
    row_pos = pd.Series(np.arange(len(out)), index=out.index)
    std_cols = {}
    if compute_error:
        for name in param_names:
            std_cols[name] = np.full(len(f), np.nan)

    frame_numbers = sorted(f[t_column].unique())
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
        con = p["con"]
        ug = _uses_global(p["layout"], con)
        tag = p["backend_tag"] or _backend_tag(
            lm_backend, kernel_route(model, p["layout"], ug, con, p["wshape"]),
            ug, con, device)
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
            backend=tag,
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

    for chunk_start in range(0, len(frame_numbers), frames_per_dispatch):
        chunk = frame_numbers[chunk_start : chunk_start + frames_per_dispatch]
        images = _frames_of(reader, chunk, ndim)
        frame_shape = tuple(images[int(chunk[0])].shape)
        stack = _stack_frames(images, chunk, device)
        frame_local = {int(t): i for i, t in enumerate(chunk)}
        sub = f[f[t_column].isin(chunk)]

        # group clusters into LADDER buckets; within a bucket, sorting by
        # cluster id makes every cluster a contiguous block, so the whole
        # bucket assembles with vectorized numpy.  Oversize clusters keep
        # the true size for the spill path.
        # Constrained sizes keep exact buckets (a rigid pose needs the true
        # n), and a laddered bucket id must not collide with a constrained
        # size: an unconstrained 5-cluster must not inherit a hexamer
        # constraint by padding into bucket 6.
        csz_all = sub["cluster_size"].to_numpy()

        def _bucket_of(c):
            c = int(c)
            if c in con_map or c > max_cluster_size:
                return c
            lad = min(_ladder_size(c), max_cluster_size)
            return c if lad in con_map else lad

        bucket_ids = np.array([_bucket_of(c) for c in csz_all])
        for n, grp in sub.groupby(bucket_ids):
            n = int(n)
            grp = grp.sort_values("cluster", kind="stable")
            if n > max_cluster_size:
                row_groups = [
                    g for _, g in grp.groupby("cluster", sort=False)
                ]
                _spill_scipy(
                    param_bufs, cost_buf, row_pos, row_groups, images,
                    model, ndim, isotropic, radius, separation,
                    param_names, pos_columns, size_cols, initial_params,
                    t_column, max_iter, max_shift, max_rms_dev,
                    param_mode_key, conv_buf, iter_buf,
                    std_cols if compute_error else None,
                )
                continue

            # integrity guard for user-supplied cluster columns: every
            # cluster id must appear exactly cluster_size times, within
            # one frame
            cid = grp["cluster"].to_numpy()
            boundaries = np.nonzero(np.diff(cid))[0] + 1
            starts = np.concatenate([[0], boundaries])
            sizes_arr = np.diff(np.concatenate([starts, [len(grp)]]))
            csz_first = grp["cluster_size"].to_numpy()[starts]
            t_arr = grp[t_column].to_numpy()
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
            flat = initial_params(grp, images)          # [rows, P]
            params0 = np.zeros((Bpad, n, P), dtype=np.float32)
            # pad features replicate member 0 (keeps bbox/window geometry
            # intact) with signal 0; fvalid gates them out of the model,
            # the Jacobian and the mask entirely
            params0[:B] = np.repeat(flat[starts], n, axis=0).reshape(
                B, n, P
            )
            params0[:B, :, 1] = 0.0
            within = np.arange(len(grp)) - np.repeat(starts, sizes_arr)
            slot_flat = np.repeat(np.arange(B), sizes_arr) * n + within
            params0[:B].reshape(-1, P)[slot_flat] = flat
            fval = np.zeros((Bpad, n), dtype=np.float32)
            fval.reshape(-1)[slot_flat] = 1.0
            fidx = np.zeros(Bpad, dtype=np.int32)
            fidx[:B] = [frame_local[int(t)] for t in t_arr[starts]]
            valid = np.zeros(Bpad, dtype=bool)
            valid[:B] = True
            pos_mat = np.full((B, n), -1, dtype=np.int64)
            pos_mat.reshape(-1)[slot_flat] = row_pos[grp.index].to_numpy()
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
                solver, layout = _bucket_solver(*bucket_args)
                backend_tag = None
            else:
                solver, layout, backend_tag = _mesh_bucket_solver(
                    mesh, *bucket_args)
            if con is not None and con.kind == "rigid":
                pose0 = positions_to_pose(params0[:, :, 2:2 + ndim], con)
            else:
                pose0 = np.zeros((Bpad, 0))

            t_dispatch = time.perf_counter()
            with diagnostics.stage(f"fit_bucket_n{n}"):
                handles = _pack_results(*solver(
                    stack, torch.as_tensor(fidx, device=device),
                    torch.as_tensor(params0, device=device),
                    torch.as_tensor(pose0, dtype=torch.float32,
                                    device=device),
                    torch.as_tensor(valid, device=device),
                    None if con is not None
                    else torch.as_tensor(fval, device=device),
                ), compute_error)
            in_flight.append(dict(
                handles=handles, n=n, B=B, Bpad=Bpad, valid=valid,
                pos_mat=pos_mat, layout=layout, wshape=wshape, con=con,
                backend_tag=backend_tag,
                dispatch_s=time.perf_counter() - t_dispatch,
                # non-finite trap context (diagnostics.debug_nans)
                params0=params0, cids=cid[starts], tvals=t_arr[starts],
            ))

        # keep at most one chunk's dispatches in flight (bounds device
        # memory: two chunks' frame stacks + results live at once)
        for p in drain_queue:
            _drain_bucket(p)
        drain_queue = in_flight
        in_flight = []

    for p in drain_queue:
        _drain_bucket(p)

    for name in param_names:
        out[name] = param_bufs[name]
    out["cost"] = cost_buf
    out["fit_converged"] = conv_buf
    out["fit_n_iter"] = iter_buf
    if compute_error:
        for name, col in std_cols.items():
            out[name + "_std"] = col

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
    param_bufs, cost_buf, row_pos, row_groups, images, model, ndim,
    isotropic, radius, separation, param_names, pos_columns, size_cols,
    initial_params, t_column, max_iter, max_shift, max_rms_dev,
    param_mode_key, conv_buf=None, iter_buf=None, std_cols=None,
):
    """Host scipy path for clusters larger than the biggest bucket; sets
    ``fit_converged``/``fit_n_iter`` from scipy's ier/nfev and fills the
    ``_std`` columns from the leastsq covariance when requested."""
    from .hostref import fit_cluster_scipy

    t_dispatch = time.perf_counter()
    n_rej = 0
    profile = _host_profile(model)
    for rows in row_groups:
        n = len(rows)
        t = int(rows[t_column].iloc[0])
        image = images[t]
        image = np.asarray(image.cpu() if isinstance(image, torch.Tensor)
                           else image)
        p0 = initial_params(rows, images)
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
        pos = row_pos[rows.index].to_numpy()
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
        diagnostics.record_batch(
            cluster_size=len(row_groups[0]),
            n_clusters=len(row_groups),
            n_lanes=len(row_groups),
            n_converged=len(row_groups) - n_rej,
            n_rejected=n_rej,
            mean_lm_iters=0.0,
            max_lm_iters=0,
            mean_rms=0.0,
            wall_s=time.perf_counter() - t_dispatch,
            backend="scipy",
        )


# train_leastsq lives in train.py, which imports this module's bucket
# machinery; the import sits at the bottom to avoid a cycle.
from .train import train_leastsq  # noqa: E402
