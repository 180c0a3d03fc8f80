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
  (hostref.py).

Not ported yet, and refused with ``NotImplementedError``: 'global'
parameter modes and globally tied rigid distances (``dimer_global()``'s
default; ROADMAP queue 1 item 8) and ``mesh=`` (queue 1 item 13).  pandas
is imported by the DataFrame entry points only.
"""
from __future__ import annotations

import math
import time
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
from .ops.fused_lm import fused_lm_2d, kernel_route
from .ops.gather import gather_stack, origins_for, radius_mask
from .ops.lm import lm_solve
from .ops.pixel_lm import pixel_lm
from .ops.residual import make_model_fns
from .ops.rigid import make_constrained_fns
from .ops.window_gather import window_gather
from .utils import default_size_columns, guess_pos_columns, validate_tuple

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["refine_leastsq"]

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
def _bucket_solver(
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
    """Build the solver for one bucket configuration.

    Returns ``(solve, layout)``; ``solve(frames [T, *S] f32,
    frame_idx [B] i32, params0 [B, n, P] f32, pose0 [B, Qt], valid [B] bool,
    fvalid [B, n] f32 | None) -> (params, rms, converged, iters, std)``
    runs on the device of ``frames``.  ``pose0`` is [B, 0] for an
    unconstrained or generic bucket and the initial pose
    (``positions_to_pose``) for a rigid one; constrained buckets are
    exact-size and ignore ``fvalid``.  ``residual_factor`` weighs a
    generic constraint's penalty rows (by its square root).

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
    if np.any(layout.global_slots):
        raise NotImplementedError(
            "'global' parameter modes need lm_solve_global, not ported "
            "yet (ROADMAP queue 1 item 8)"
        )
    _refuse_global_distance(constraint)
    pos_idx = list(layout.pos_param_idx)
    route = kernel_route(model, layout, False, constraint, window_shape)
    if lm_backend == "kernel" and route is None:
        raise ValueError(
            "lm_backend='kernel' unsupported for this configuration "
            f"(V={layout.n_slots} slots, window {window_shape}, "
            f"constraint {getattr(constraint, 'name', None)!r})"
        )

    def solve(frames, frame_idx, params0, pose0, valid, fvalid=None):
        device = frames.device
        taken = _route_taken(lm_backend, route, device)
        B = params0.shape[0]
        frame_shape = tuple(frames.shape[1:])
        signal0 = params0[..., layout.signal_param_idx]
        norm = torch.clamp(torch.amax(torch.abs(signal0), dim=1), min=1e-6)
        lo_np, hi_np = _slot_bounds(layout, window_shape, frame_shape,
                                    bounds_key, constraint)
        lo_b = torch.as_tensor(lo_np, device=device)
        hi_b = torch.as_tensor(hi_np, device=device)
        if constraint is None:
            fns = make_model_fns(model, layout, window_shape, device=device)
            residual, residual_jac = fns.residual, fns.residual_jac
            vect0 = layout.vect_from_params(params0)

            def positions_of(vect):
                return layout.vect_to_params(vect, params0)[..., pos_idx]

            def params_of(vect):
                return layout.vect_to_params(vect, params0)
        else:
            # constrained buckets are exact-size: no pad features to gate
            fvalid = None
            cfns = make_constrained_fns(model, layout, window_shape,
                                        constraint, residual_factor, device)
            residual, residual_jac = cfns.residual, cfns.residual_jac
            vect0 = cfns.vect_of(params0, pose0.to(params0.dtype))

            def positions_of(vect):
                return cfns.positions_of(vect, params0)

            def params_of(vect):
                return cfns.params_of(vect, params0)
        fv_extra = () if fvalid is None else (fvalid,)

        def solve_round(vect, need):
            pos_at = positions_of(vect).contiguous()
            origin = origins_for(pos_at, window_shape, frame_shape)
            kw = dict(model=model, layout=layout,
                      window_shape=window_shape, lo=lo_np, hi=hi_np,
                      radius=radius, max_iter=lm_max_iter, ftol=ftol,
                      xtol=xtol, constraint=constraint)
            if taken == "fused":
                res = fused_lm_2d(vect, params0, frames, frame_idx, pos_at,
                                  origin, norm, need, fvalid, **kw)
            elif taken == "gathered":
                pixels = gather(frames, frame_idx, origin, window_shape)
                res = pixel_lm(vect, params0, pixels, pos_at, origin, norm,
                               need, fvalid, streaming=streaming, **kw)
            else:
                pixels = gather(frames, frame_idx, origin, window_shape)
                mask = radius_mask(pos_at, origin, window_shape, radius,
                                   fvalid=fvalid)
                res = lm_solve(
                    residual, residual_jac, vect,
                    (params0, pixels, mask, origin, norm) + fv_extra,
                    max_iter=lm_max_iter, ftol=ftol, xtol=xtol,
                    lower=lo_b, upper=hi_b, valid=need,
                )._replace(npix=mask.sum(dim=1))
            return res, pos_at

        # Refit-on-shift: a lane whose positions moved more than max_shift
        # is re-gathered around its new positions and solved again.  The
        # next round starts from the latest iterate, but the REPORTED fit
        # is each lane's best finite round (re-centering changes the data
        # a lane is fit against, and a later round can be worse).
        vect = vect0
        need = valid
        iters = torch.zeros((B,), dtype=torch.int32, device=device)
        vect_best = vect0
        rms_best = torch.full((B,), torch.inf, device=device)
        conv_best = torch.zeros((B,), dtype=torch.bool, device=device)
        for it in range(max(max_iter, 1)):
            if it > 0 and not bool(need.any()):
                break
            with diagnostics.stage(f"refit_round_{it}"):
                res, pos_at = solve_round(vect, need)
            shift = torch.amax(
                torch.abs(positions_of(res.x) - pos_at), dim=(1, 2)
            )
            npx_raw = res.npix
            npx = torch.clamp(npx_raw, min=1.0)
            # an empty fit mask (every feature outside its window) has
            # residual ≡ 0 — that is a FAILED fit, not a perfect one
            rms_new = torch.where(
                npx_raw > 0.0, torch.sqrt(res.cost / npx), torch.inf
            )
            iters = iters + torch.where(need, res.n_iter, 0)
            improved = need & (rms_new < rms_best)
            vect_best = torch.where(improved[:, None], res.x, vect_best)
            rms_best = torch.where(improved, rms_new, rms_best)
            conv_best = torch.where(improved, res.converged, conv_best)
            need = need & (shift > max_shift)
            vect = res.x
        params = params_of(vect_best)

        if not compute_error:
            return (params, rms_best, conv_best, iters,
                    torch.zeros((0,), device=device))
        pos = positions_of(vect_best)
        origin = origins_for(pos, window_shape, frame_shape)
        pixels = gather(frames, frame_idx, origin, window_shape)
        mask = radius_mask(pos, origin, window_shape, radius, fvalid=fvalid)
        r, J = residual_jac(
            vect_best, params0, pixels, mask, origin, norm, *fv_extra
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
            lambda v: positions_of(v[None])[0]))(vect_best)  # [B, n, D, Vc]
        var_pos = torch.einsum("bndu,buv,bndv->bnd", G, cov, G) \
            * sigma2[:, None, None]
        std_params = layout.vect_to_params(std_vect[:, cfns.Qt:], nan_params)
        p0 = pos_idx[0]
        std_params = torch.cat(
            [std_params[..., :p0], torch.sqrt(torch.clamp(var_pos, min=0.0)),
             std_params[..., p0 + ndim:]], dim=-1)
        return params, rms_best, conv_best, iters, std_params

    return solve, layout


def _refuse_global_distance(constraint):
    """A rigid distance tied across every cluster of the fit needs the
    cross-lane solve the port does not have yet."""
    if (constraint is not None and constraint.kind == "rigid"
            and constraint.fit_dist and constraint.dist_mode == "global"):
        raise NotImplementedError(
            f"constraint {constraint.name!r} ties one distance across all "
            "clusters (dist_mode='global'): that needs lm_solve_global and "
            "the whole-video joint distance, not ported yet (ROADMAP queue "
            "1 item 8); dimer_global(mode='cluster') fits one per cluster"
        )


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
    device="cpu",
) -> "pd.DataFrame":
    """Simultaneously refine overlapping features cluster-by-cluster.

    DataFrame in/out, as the reference's ``refine_leastsq``: requires
    position columns (+ optionally 'signal', 'size'/'size_*', 'frame');
    adds/updates the refined parameter columns, 'cluster',
    'cluster_size', 'cost' (NaN = rejected fit), 'fit_converged' and
    'fit_n_iter'.  Frames are stacked per ``frames_per_dispatch`` chunk
    onto ``device``, where every bucket is solved.

    ``lm_backend``: 'auto' (on CUDA, each bucket's kernel route:
    ``fused_lm_2d`` for 2D windows, ``window_gather`` then ``pixel_lm``
    for 3D and large 2D ones), 'kernel' (force the kernel route; its plain
    versions on CPU) or 'torch' (``lm_solve``).  Dispatches of constrained
    buckets are tagged with their kind: ``cuda-fused-rigid``,
    ``cuda-torch-penalty``, ...

    ``constraints``: ``dimer``/``trimer``/``tetramer``/``dimer_global``
    objects or reference-style ``{'type': 'eq', 'fun': f, 'args': a,
    'cluster_size': n}`` dicts (``fun`` takes torch positions [n, D]);
    a constraint built for another ndim raises ``ValueError``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-device fits) is not ported yet (ROADMAP queue 1 "
            "item 13)"
        )
    device = torch.device(device)
    if pos_columns is None:
        pos_columns = guess_pos_columns(f)
    ndim = len(pos_columns)
    con_map = wrap_constraint_dicts(constraints, ndim)
    for con in con_map.values():
        _refuse_global_distance(con)
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
            f, separation, pos_columns, t_column, backend=backend_find
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
        route = _route_taken(
            lm_backend,
            kernel_route(model, p["layout"], False, con, p["wshape"]),
            device,
        )
        kind = "" if con is None else (
            "-rigid" if con.kind == "rigid" else "-penalty")
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
            backend=f"{device.type}-{route}{kind}",
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
        vals = [images[int(t)] for t in chunk]
        if any(isinstance(v, torch.Tensor) for v in vals):
            stack = torch.stack(
                [torch.as_tensor(v, dtype=torch.float32, device=device)
                 for v in vals], dim=0
            )
        else:
            stack = torch.as_tensor(
                np.stack(vals, axis=0).astype(np.float32), device=device
            )
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
            Bpad = max(_LANE_PAD, int(np.ceil(B / _LANE_PAD)) * _LANE_PAD)
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
            solver, layout = _bucket_solver(
                model, ndim, isotropic, n, param_mode_key, wshape,
                radius, bounds_key, con, residual_factor,
                max_iter, max_shift, lm_max_iter, ftol, xtol,
                compute_error, lm_backend,
            )
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
    return out


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
