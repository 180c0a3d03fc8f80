"""Batched residual / Jacobian construction for cluster model images.

PyTorch counterpart of ``clustertracking_tpu/ops/residual.py``.  One call
evaluates the residual and the *analytic* Jacobian for a whole bucket of
clusters (batch axis B = clusters of one size ``n`` in one window shape).

Model (see models/registry.py)::

    I(x)  = background + sum_i signal_i * fun(r2_i, *extras_i)
    r2_i  = sum_d ((x_d - pos_{i,d}) / size_{i,d})**2

Layouts follow the reference, pixel axis last::

    offsets [D, Npix];  dxs [B, n, D, Npix];  J [B, V, Npix]  (slot-major)

The pixel at window index (i0, i1, ...) has position origin + index.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..models.packing import ParamLayout
from ..models.registry import ModelSpec, elementwise

__all__ = ["window_offsets", "make_model_fns", "ModelFns"]


class ModelFns(NamedTuple):
    """Closures for one bucket (fixed layout + window shape + device)."""

    residual: Callable          # (vect, const, pixels, mask, origin, norm)
    residual_jac: Callable      # same args -> (r [B,Npix], J [B,V,Npix])
    image: Callable             # (vect, const, origin) -> model image
    image_from_params: Callable  # (params [B,n,P], origin) -> model image


def window_offsets(window_shape: Tuple[int, ...], dtype=torch.float32,
                   device="cpu"):
    """[D, Npix] tensor of pixel index offsets for a window, built once a
    window, dtype and device and kept (callers only read it)."""
    return _window_offsets(tuple(int(s) for s in window_shape), dtype,
                           torch.device(device))


@lru_cache(maxsize=64)
def _window_offsets(window_shape, dtype, device):
    grids = np.meshgrid(
        *[np.arange(s) for s in window_shape], indexing="ij"
    )
    return torch.as_tensor(
        np.stack([g.ravel() for g in grids], axis=0), dtype=dtype,
        device=device,
    )


def make_model_fns(
    model: ModelSpec,
    layout: ParamLayout,
    window_shape: Tuple[int, ...],
    dtype=torch.float32,
    device="cpu",
):
    """Build the model closures for one bucket on ``device``.

    All take::

        vect         [B, V]     — packed optimizer vector per cluster
        const_params [B, n, P]  — full param array supplying const values
        pixels       [B, Npix]  — flattened window pixels
        mask         [B, Npix]  — 1.0 inside the fit region, 0.0 outside
        origin       [B, D]     — integer window corner coordinates
        norm         [B]        — residual normalization (signal scale)

    returning::

        residual     -> r [B, Npix]
        residual_jac -> (r [B, Npix], J [B, V, Npix])   (slot-major J)
    """
    n = layout.n_features
    V = layout.n_slots
    offsets = window_offsets(window_shape, dtype, device)  # [D, Npix]
    Npix = offsets.shape[1]
    n_extra = len(model.extra_params)
    extra_param_idx = tuple(
        layout.param_names.index(name) for name in model.extra_params
    )
    pos_idx = list(layout.pos_param_idx)
    size_idx = list(layout.size_param_idx)

    fun = model.fun
    dfun_f = model.dfun_f
    if model.dfun is not None:
        dfun_dr2 = model.dfun
    else:
        dfun_dr2 = elementwise(model.dfun_dr2())
    dfun_dex = [elementwise(model.dfun_dextra(k)) for k in range(n_extra)]

    def _split(params):
        pos = params[..., pos_idx]                          # [B, n, D]
        size = params[..., size_idx]                        # [B, n, 1|D]
        signal = params[..., layout.signal_param_idx]       # [B, n]
        bg = params[..., 0, layout.background_param_idx]    # [B]
        extras = [params[..., j] for j in extra_param_idx]  # each [B, n]
        return pos, size, signal, bg, extras

    def _geometry(pos, size, origin):
        # Window-local arithmetic: dx = offsets - (pos - origin) keeps the
        # magnitudes O(window).  Sizes divide per pixel, as in the
        # reference and the kernel.
        rel = pos - origin[:, None, :].to(dtype)            # [B, n, D]
        size_d = size.expand(rel.shape)                     # [B, n, D]
        dx = offsets[None, None] - rel[..., None]           # [B,n,D,Npix]
        dxs = dx / size_d[..., None]
        r2 = torch.sum(dxs * dxs, dim=-2)                   # [B, n, Npix]
        return dxs, r2

    def _profile(r2, extras):
        if n_extra:
            ex = [e[:, :, None] for e in extras]            # [B, n, 1]
            return fun(r2, *ex)
        return fun(r2)

    def image_from_params(params, origin, fvalid=None):
        pos, size, signal, bg, extras = _split(params)
        if fvalid is not None:  # ladder pad features contribute nothing
            signal = signal * fvalid
        _, r2 = _geometry(pos, size, origin)
        fvals = _profile(r2, extras)
        return bg[:, None] + torch.sum(signal[:, :, None] * fvals, dim=1)

    def model_image_fn(vect, const_params, origin, fvalid=None):
        params = layout.vect_to_params(vect, const_params)
        return image_from_params(params, origin, fvalid)

    def residual_fn(vect, const_params, pixels, mask, origin, norm,
                    fvalid=None):
        img = model_image_fn(vect, const_params, origin, fvalid)
        # (mask / norm) first — the same rounding as residual_jac_fn's
        # weight and the kernel's, so accept decisions stay aligned
        return (img - pixels) * (mask / norm[:, None])

    def residual_jac_fn(vect, const_params, pixels, mask, origin, norm,
                        fvalid=None):
        params = layout.vect_to_params(vect, const_params)
        pos, size, signal, bg, extras = _split(params)
        if fvalid is not None:
            # a pad feature (fvalid 0) contributes no model intensity and
            # ZERO Jacobian rows; signal gating covers every column but
            # the signal one, which is gated explicitly below
            signal = signal * fvalid
        dxs, r2 = _geometry(pos, size, origin)
        ex_b = [e[:, :, None] for e in extras]
        fvals = fun(r2, *ex_b) if n_extra else fun(r2)       # [B, n, Npix]
        if fvalid is not None:
            fvals_sig = fvals * fvalid[:, :, None]
        else:
            fvals_sig = fvals
        img = bg[:, None] + torch.sum(signal[:, :, None] * fvals, dim=1)
        w = mask / norm[:, None]                             # [B, Npix]
        r = (img - pixels) * w

        if dfun_f is not None:  # reuse the forward value (one exp, not two)
            df = dfun_f(fvals, r2, *ex_b)
        else:
            df = dfun_dr2(r2, *ex_b) if n_extra else dfun_dr2(r2)
        sig_df = signal[:, :, None] * df                     # [B, n, Npix]

        size_bn = size.expand(pos.shape)                     # [B, n, D]

        # Per-param derivative columns cols[p] : [B, n, Npix], computed
        # only for fitted params; J rows are assembled by static stacking
        # (shared slots sum their contributors).
        cols = {}

        p_bg = layout.background_param_idx
        if layout.slot_idx[0, p_bg] >= 0:
            # the single shared background slot: per-feature w/n so the
            # summed row equals w
            cols[p_bg] = (w / n)[:, None, :].expand(w.shape[0], n, Npix)

        def fitted(p):
            return layout.slot_idx[0, p] >= 0

        if fitted(layout.signal_param_idx):
            cols[layout.signal_param_idx] = fvals_sig * w[:, None, :]

        for d_axis, p in enumerate(layout.pos_param_idx):
            if fitted(p):
                s_d = size_bn[..., d_axis]                   # [B, n]
                cols[p] = (
                    sig_df * (-2.0) * dxs[:, :, d_axis, :]
                    / s_d[..., None] * w[:, None, :]
                )

        if layout.isotropic:
            p = layout.size_param_idx[0]
            if fitted(p):
                s = size[..., 0]
                cols[p] = (
                    sig_df * (-2.0) * r2 / s[:, :, None] * w[:, None, :]
                )
        else:
            for d_axis, p in enumerate(layout.size_param_idx):
                if fitted(p):
                    s_d = size[..., d_axis]
                    cols[p] = (
                        sig_df * (-2.0) * dxs[:, :, d_axis, :] ** 2
                        / s_d[:, :, None] * w[:, None, :]
                    )

        for k, p in enumerate(extra_param_idx):
            if fitted(p):
                cols[p] = (
                    signal[:, :, None] * dfun_dex[k](r2, *ex_b)
                    * w[:, None, :]
                )

        # slot v ← sum of its (feature, param) contributors (static map)
        rows = [None] * V
        for p, c in cols.items():
            slots = layout.slot_idx[:, p]
            if slots[0] == slots[-1] and n > 1:  # shared slot: sum feats
                rows[int(slots[0])] = torch.sum(c, dim=1)
            else:
                for i in range(n):
                    rows[int(slots[i])] = c[:, i, :]
        J = torch.stack(rows, dim=1)                         # [B, V, Npix]
        return r, J

    return ModelFns(
        residual=residual_fn,
        residual_jac=residual_jac_fn,
        image=model_image_fn,
        image_from_params=image_from_params,
    )
