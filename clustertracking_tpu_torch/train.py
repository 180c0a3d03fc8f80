"""train_leastsq — joint calibration of 'global'-mode model parameters.

Counterpart of ``clustertracking_tpu/train.py``.  The 'global' parameters
(typically the coefficients of an experimental PSF such as
``inv_series_<n>``) are shared by every sampled cluster, and are found by
alternating two exact solves until they stop moving:

1. **Joint-within-dispatch refit** — every sampled cluster is refit by
   ``refine_leastsq`` with the trained slots in 'global' mode, so each
   bucket dispatch solves its shared parameters jointly with the
   per-cluster ones, on the device (on CUDA one launch of
   ``csrc/tied_lm.cu``, ``ops/tied_lm.py``; else
   ``ops/lm.py::lm_solve_global``).
2. **Exact cross-bucket global step** — at the fitted per-cluster
   parameters, the Gauss–Newton normal equations of the joint
   (unnormalized) residual with respect to the shared slots are pooled
   over every bucket and frame chunk (``_global_eq``, on the device; the
   sums in float64 on the host) and solved with Levenberg–Marquardt
   damping and backtracking on the joint cost, in float64 numpy.

The pooled normal equations weight each bucket by its information, so
dissimilar buckets (cluster sizes, signal, counts) cannot bias the shared
values as a mean of per-bucket estimates would.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from .find import find_clusters
from .models.packing import build_layout, param_names_for
from .models.registry import get_model
from .ops.gather import origins_for, radius_mask
from .ops.residual import make_model_fns
from .ops.window_gather import window_gather
from .refine import (
    _mesh_device, _pooled_buckets, _pooled_eq, refine_leastsq)
from .utils import default_size_columns, guess_pos_columns, validate_tuple

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["train_leastsq"]


def _global_eq(model, ndim, isotropic, n, trained_key, window_shape, radius,
               device):
    """The joint normal equations of one bucket configuration:
    ``accum(frames, frame_idx, params0, valid, xg) -> (H [G, G], g [G],
    cost)``.

    Only the trained parameters carry slots (mode 'global', one shared
    slot each, in ``trained_key`` order, which is parameter order); every
    other parameter is held at its fitted per-cluster value."""
    mode = {name: "global" if name in trained_key else "const"
            for name in param_names_for(model, ndim, isotropic)}
    layout = build_layout(model, ndim, isotropic, n, mode)
    fns = make_model_fns(model, layout, window_shape, device=device)
    pos_idx = list(layout.pos_param_idx)
    tp_idx = [layout.param_names.index(t) for t in trained_key]

    def accum(frames, frame_idx, params0, valid, xg):
        params = params0.clone()
        params[..., tp_idx] = xg
        # Unnormalized residuals: under uniform pixel noise the weight of
        # every lane is 1, so bright clusters carry information ∝ signal².
        # refine's per-lane signal normalization cannot move a lane's own
        # optimum, but across lanes it would equalize their weights.
        norm = torch.ones((params0.shape[0],), dtype=params0.dtype,
                          device=params0.device)
        pos = params[..., pos_idx]
        origin = origins_for(pos, window_shape, tuple(frames.shape[1:]))
        pixels = window_gather(frames, frame_idx, origin, window_shape)
        mask = radius_mask(pos, origin, window_shape, radius)
        vect = layout.vect_from_params(params)              # [B, G]
        r, J = fns.residual_jac(vect, params, pixels, mask, origin, norm)
        w = valid.to(r.dtype)
        rw = r * w[:, None]
        g = torch.einsum("bgn,bn->g", J, rw)
        H = torch.einsum("bgn,bhn->gh", J * w[:, None, None], J)
        return H, g, torch.sum(rw * r)

    return accum


def train_leastsq(
    f: "pd.DataFrame",
    reader,
    diameter,
    separation=None,
    fit_function="inv_series_2",
    param_mode: Optional[dict] = None,
    tol: float = 1e-7,
    pos_columns: Optional[list] = None,
    t_column: str = "frame",
    max_samples: int = 512,
    max_rounds: int = 8,
    param_val: Optional[dict] = None,
    frames_per_dispatch: int = 32,
    device=None,
    **kwargs,
) -> dict:
    """Calibrate 'global'-mode parameters across many features and frames.

    Returns the learned values as a dict to feed back through
    ``refine_leastsq(param_val=...)``.  Model extras default to 'global';
    the isotropic 'size' and 'background' can be trained too
    (``param_mode={'size': 'global'}``).  Per-axis sizes, positions and
    signal are per-feature quantities and raise ``ValueError``, and so does
    'size' set 'global' on data with per-axis size columns (the reference
    trains nothing for it, silently).

    The first ``max_samples`` clusters of at most ``max_cluster_size``
    features are sampled.  ``device`` as ``refine_leastsq``'s: None is
    'cuda', and raises ``RuntimeError`` where no CUDA device exists.
    Other keyword arguments go to ``refine_leastsq``: ``mesh=`` splits
    every refit's lanes over its devices (``device`` then defaults to its
    first), while the pooled Newton step stays on ``device``, as in the
    reference.  See the module docstring for the method.
    """
    device = _mesh_device(kwargs.get("mesh"), device, "train_leastsq")
    if pos_columns is None:
        pos_columns = guess_pos_columns(f)
    ndim = len(pos_columns)
    model = get_model(fit_function)
    diameter_t = validate_tuple(diameter, ndim)
    radius = tuple(d / 2.0 for d in diameter_t)
    sep_t = validate_tuple(
        separation if separation is not None else diameter, ndim)

    if "cluster" not in f.columns:
        f = find_clusters(f, sep_t, pos_columns, t_column)
    if t_column not in f.columns:
        f = f.copy()
        f[t_column] = 0

    # sample clusters across all sizes (ids in order of appearance); the
    # host scipy path of oversized clusters cannot join the joint system
    max_n = int(kwargs.get("max_cluster_size", 8))
    sel = f[f["cluster_size"] <= max_n]
    ids = sel["cluster"].unique()[:max_samples]
    sel = sel[sel["cluster"].isin(ids)]

    aniso_cols = default_size_columns(ndim, False)
    isotropic = not any(c in f.columns for c in aniso_cols)

    mode = dict(param_mode or {})
    for name in model.extra_params:
        mode.setdefault(name, "global")
    names = param_names_for(model, ndim, isotropic)
    if not isotropic and mode.get("size") == "global":
        raise ValueError(
            "cannot train 'size' globally on data with per-axis size "
            f"columns {aniso_cols}: per-axis sizes are per-feature "
            "quantities"
        )
    trained = [n for n in names if mode.get(n) == "global"]
    untrainable = [
        t for t in trained
        if t not in model.extra_params and t not in ("size", "background")
    ]
    if untrainable:
        raise ValueError(
            f"cannot train {untrainable} globally: only model extras, "
            "isotropic 'size', and 'background' are shared quantities"
        )

    # initial values: user param_val > data column mean > model default
    user_val = dict(param_val or {})
    x = np.zeros(len(trained))
    for j, t in enumerate(trained):
        if t in user_val:
            x[j] = float(user_val.pop(t))
        elif t in sel.columns:
            x[j] = float(sel[t].mean())
        elif t in model.default:
            x[j] = float(model.default[t])
        elif t == "size":
            x[j] = float(np.mean(radius)) / 2.0
        else:  # background
            x[j] = 0.0
    if not trained:
        return {}

    # the trained columns are dropped, so param_val supplies the current
    # shared estimate as every refit's start
    sel_r = sel.drop(columns=[c for c in trained if c in sel.columns])
    trained_key = tuple(trained)
    rtol = math.sqrt(tol)
    learned = dict(zip(trained, x))

    for _ in range(max_rounds):
        # (1) refit, the shared slots tied jointly within each dispatch
        fitted = refine_leastsq(
            sel_r, reader, diameter, separation,
            fit_function=model, param_mode=mode,
            param_val={**user_val, **learned},
            pos_columns=pos_columns, t_column=t_column,
            ftol=tol, xtol=tol, frames_per_dispatch=frames_per_dispatch,
            device=device, **kwargs,
        )
        ok = fitted["cost"].notna()
        if not ok.any():
            break
        acc_rows = fitted[ok]
        # warm start: the mean of the per-dispatch joint estimates
        x = np.array([float(acc_rows[t].mean()) for t in trained])

        # (2) the exact joint step over the pooled normal equations
        buckets = _pooled_buckets(
            acc_rows, reader, ndim, radius, sep_t, names, t_column,
            frames_per_dispatch,
            lambda n, wshape: _global_eq(model, ndim, isotropic, n,
                                         trained_key, wshape, radius,
                                         device),
            device)

        def eval_at(xg):
            return _pooled_eq(buckets, xg)

        Hx, gx, cx = eval_at(x)
        lam = 1e-3
        x_round0 = x.copy()
        for _ in range(25):
            d = np.maximum(np.diag(Hx), 1e-12)
            A = Hx + lam * np.diag(d) + 1e-12 * np.eye(len(x))
            delta = -np.linalg.solve(A, gx)
            xt = x + delta
            Ht, gt, ct_ = eval_at(xt)
            if ct_ < cx:
                rel = (cx - ct_) / max(cx, 1e-30)
                step = float(np.max(np.abs(delta)))
                x, Hx, gx, cx = xt, Ht, gt, ct_
                lam = max(lam * 0.25, 1e-8)
                if rel < tol or step <= rtol * (rtol + np.max(np.abs(x))):
                    break
            else:
                lam *= 4.0
                if lam > 1e10:
                    break
        learned = dict(zip(trained, (float(v) for v in x)))

        # outer stop: the shared estimate stopped moving between rounds
        denom = np.maximum(np.abs(x_round0), 1e-12)
        if np.max(np.abs(x - x_round0) / denom) < rtol:
            break
    return learned

