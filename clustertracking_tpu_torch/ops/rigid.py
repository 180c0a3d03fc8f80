"""Constrained buckets: the optimizer vector over a pose, its residual and
Jacobian, and the compact slot bookkeeping of the rigid kernels.

Counterpart of the constrained branches of
``clustertracking_tpu/refine.py::_bucket_solver`` (refine.py:167-317) and
of ``_rigid_supported`` / ``_rigid_kernel_slots`` in
``clustertracking_tpu/ops/pallas_lm.py`` (:173-219).

A rigid bucket fits ``vect = [pose (Qt), std slots (V)]``: Qt = the pose
(``constraints.pose_dim``) plus a fitted distance when the constraint has
one; the n·D position slots inside the std segment are inert, since the
positions come from the pose.  Its Jacobian is the analytic one of
``ops/residual.py`` chained through the per-lane ``jacfwd`` of
``pose_to_positions`` (position columns zeroed).  A generic (penalty)
bucket fits the std vector and appends ``sqrt(residual_factor)·fun(pos)``
rows to the residual; its Jacobian, and that of a rigid bucket whose
positions are not all fitted slots, is per-lane forward-mode AD, built
[B, Npix, Vc] per lane and never [B, Npix, B, Vc].
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..constraints import pose_dim, pose_to_positions
from ..models.packing import ParamLayout
from .residual import make_model_fns

__all__ = ["ConstrainedFns", "make_constrained_fns", "rigid_kernel_slots",
           "rigid_supported"]


class ConstrainedFns(NamedTuple):
    """Closures of one constrained bucket; ``Qt`` pose slots lead vect."""

    Qt: int
    positions_of: Callable   # (vect, params_ref) -> [B, n, D]
    params_of: Callable      # (vect, params_ref) -> [B, n, P]
    vect_of: Callable        # (params [B, n, P], pose [B, Qt]) -> vect
    residual: Callable       # (vect, params_ref, pixels, mask, origin, norm)
    residual_jac: Callable   # same args -> (r [B, N], J [B, Vc, N])


def _pos_slots_fitted(layout: ParamLayout) -> bool:
    return all(
        layout.slot_idx[i, p] >= 0
        for i in range(layout.n_features)
        for p in layout.pos_param_idx
    )


def rigid_supported(layout: ParamLayout, constraint) -> bool:
    """Constraints the rigid kernels inline (pallas_lm.py::_rigid_supported):
    rigid, 2D or 3D, a distance that is fixed or fitted per cluster, every
    position a fitted slot (the chain rule needs their Jacobian rows)."""
    if getattr(constraint, "kind", None) != "rigid":
        return False
    if layout.ndim not in (2, 3):
        return False
    if constraint.fit_dist and constraint.dist_mode == "global":
        return False
    return _pos_slots_fitted(layout)


def rigid_kernel_slots(layout: ParamLayout, constraint):
    """(Qt, keep, drop, remap) of a rigid bucket: ``keep`` / ``drop`` index
    the full vect (the kernel's compact x is vect[:, keep] = [pose, the
    non-position std slots]; dropped are the inert position slots);
    ``remap`` [V] maps a std slot to its compact row, −1 for positions."""
    n = layout.n_features
    Qt = pose_dim(constraint) + int(constraint.fit_dist)
    pos_slots = {
        int(layout.slot_idx[i, p])
        for i in range(n)
        for p in layout.pos_param_idx
    }
    keep = list(range(Qt))
    remap = np.full(layout.n_slots, -1, np.int32)
    for s in range(layout.n_slots):
        if s not in pos_slots:
            remap[s] = len(keep)
            keep.append(Qt + s)
    drop = [Qt + s for s in sorted(pos_slots)]
    return Qt, keep, drop, remap


def _lane_jac(residual_fn):
    """Per-lane forward-mode Jacobian of ``residual_fn``: vmap over lanes
    of jacfwd of one lane's residual, so the intermediate is
    [B, N, Vc] and not the [B, N, B, Vc] of a jacfwd over the batch."""

    def one(v, pr, px, mk, org, nm):
        return residual_fn(v[None], pr[None], px[None], mk[None], org[None],
                           nm[None])[0]

    jac_one = torch.func.jacfwd(one, argnums=0)

    def residual_jac(vect, params_ref, pixels, mask, origin, norm):
        r = residual_fn(vect, params_ref, pixels, mask, origin, norm)
        J = torch.func.vmap(jac_one)(vect, params_ref, pixels, mask, origin,
                                     norm)                 # [B, N, Vc]
        return r, J.transpose(1, 2)

    return residual_jac


def make_constrained_fns(model, layout: ParamLayout, window_shape,
                         constraint, residual_factor=1e5,
                         device="cpu") -> ConstrainedFns:
    """The closures of a bucket under ``constraint`` (rigid or generic)."""
    fns = make_model_fns(model, layout, tuple(window_shape), device=device)
    pos_idx = list(layout.pos_param_idx)
    n, D = layout.n_features, layout.ndim

    if constraint.kind == "rigid":
        Qt = pose_dim(constraint) + int(constraint.fit_dist)

        def positions_of(vect, params_ref):
            return pose_to_positions(vect[:, :Qt], constraint)

        def params_of(vect, params_ref):
            params = layout.vect_to_params(vect[:, Qt:], params_ref)
            pos = positions_of(vect, params_ref).to(params.dtype)
            p0 = pos_idx[0]  # positions are the D params after signal
            return torch.cat([params[..., :p0], pos, params[..., p0 + D:]],
                             dim=-1)

        def vect_of(params, pose):
            return torch.cat([pose, layout.vect_from_params(params)], dim=1)

        def residual(vect, params_ref, pixels, mask, origin, norm):
            img = fns.image_from_params(params_of(vect, params_ref), origin)
            # (mask / norm) first: the rounding of residual_jac's weight
            return (img - pixels) * (mask / norm[:, None])

        if _pos_slots_fitted(layout):
            pos_rows = [int(layout.slot_idx[i, p]) for i in range(n)
                        for p in pos_idx]
            pose_jac = torch.func.vmap(torch.func.jacfwd(
                lambda p: pose_to_positions(p[None], constraint)[0]))

            def residual_jac(vect, params_ref, pixels, mask, origin, norm):
                params = params_of(vect, params_ref)
                r, J_std = fns.residual_jac(
                    layout.vect_from_params(params), params, pixels, mask,
                    origin, norm)                          # [B, V, Npix]
                G = pose_jac(vect[:, :Qt])                 # [B, n, D, Qt]
                B, _, Npx = J_std.shape
                Jpos = J_std[:, pos_rows, :].reshape(B, n, D, Npx)
                J_pose = torch.einsum("bndq,bndp->bqp", G, Jpos)
                # the pose overrides the position slots: their own columns
                # are zero (damping handles the zero diagonal)
                J_free = J_std.clone()
                J_free[:, pos_rows, :] = 0.0
                return r, torch.cat([J_pose, J_free], dim=1)
        else:
            residual_jac = _lane_jac(residual)
    else:
        Qt = 0
        pen_w = math.sqrt(residual_factor)
        con_fun = torch.func.vmap(constraint.fun)

        def positions_of(vect, params_ref):
            p0 = pos_idx[0]   # a slice: no index copied to the device
            return layout.vect_to_params(vect, params_ref)[..., p0:p0 + D]

        def params_of(vect, params_ref):
            return layout.vect_to_params(vect, params_ref)

        def vect_of(params, pose):
            return layout.vect_from_params(params)

        def residual(vect, params_ref, pixels, mask, origin, norm):
            r = fns.residual(vect, params_ref, pixels, mask, origin, norm)
            pen = pen_w * con_fun(positions_of(vect, params_ref))
            return torch.cat([r, pen.reshape(r.shape[0], -1)], dim=1)

        residual_jac = _lane_jac(residual)

    return ConstrainedFns(Qt, positions_of, params_of, vect_of, residual,
                          residual_jac)
