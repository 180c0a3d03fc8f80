"""Batched window origins, window gather and fit-region masks.

PyTorch counterpart of ``clustertracking_tpu/ops/gather.py``.  A whole
bucket of windows is cut out of the stacked frames with one advanced-index
read, and the within-radius ellipsoidal masks are computed from the
current feature positions, on the device that holds the tensors.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from .residual import window_offsets

__all__ = ["clamp_origins", "gather_stack", "radius_mask", "origins_for",
           "shape_tensor"]


@lru_cache(maxsize=128)
def _shape_tensor(values, dtype, device):
    return torch.as_tensor(values, dtype=dtype, device=device)


def shape_tensor(values, dtype, device):
    """``values`` (a few numbers: a window's extents, a radius) as a [D]
    tensor on ``device``, built once a device and kept, so that a solve's
    rounds copy no shape to the device."""
    return _shape_tensor(tuple(values), dtype, torch.device(device))


def origins_for(pos, window_shape: Tuple[int, ...], frame_shape):
    """Integer window-corner coordinates centering each cluster's bbox.

    pos: [B, n, D] feature positions; returns [B, D] int32 origins clamped
    so every window lies inside the frame.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    lo = torch.amin(pos, dim=1)
    hi = torch.amax(pos, dim=1)
    center = 0.5 * (lo + hi)
    w = shape_tensor(map(int, window_shape), pos.dtype, pos.device)
    origin = torch.round(center - 0.5 * (w - 1.0)).to(torch.int32)
    return clamp_origins(origin, window_shape, frame_shape)


def clamp_origins(origin, window_shape, frame_shape):
    maxi = shape_tensor((int(fs) - int(ws) for fs, ws in zip(
        frame_shape, window_shape)), torch.int32, origin.device)
    return torch.minimum(torch.clamp(origin, min=0), maxi)


def gather_stack(frames, frame_idx, origins, window_shape):
    """Gather [B, Npix] windows from stacked frames [T, *S].

    ``origins`` [B, D] must already be clamped (``clamp_origins``); each
    window is read with one flat advanced index into the frame stack."""
    frame_shape = frames.shape[1:]
    offs = window_offsets(window_shape, torch.long, frames.device)  # [D, Np]
    lin = frame_idx.to(torch.long)[:, None]
    for d, size in enumerate(frame_shape):
        lin = lin * size + (
            origins[:, d].to(torch.long)[:, None] + offs[d][None]
        )
    return frames.reshape(-1)[lin]


def radius_mask(pos, origin, window_shape: Tuple[int, ...], radius,
                dtype=torch.float32, fvalid=None):
    """1.0 where a pixel lies within the (ellipsoidal) radius of ANY
    feature of the cluster, else 0.0.

    pos: [B, n, D]; origin: [B, D] int; radius: length-D sequence;
    fvalid: optional [B, n] (ladder pad features claim no pixels).
    """
    offsets = window_offsets(window_shape, dtype, pos.device)  # [D, Npix]
    rel = pos - origin[:, None, :].to(dtype)                   # [B, n, D]
    r = shape_tensor(map(float, radius), dtype, pos.device)
    d = (offsets[None, None] - rel[..., None]) / r[:, None]    # [B,n,D,Npix]
    r2 = torch.sum(d * d, dim=-2)
    if fvalid is not None:
        r2 = torch.where(fvalid[:, :, None] > 0.5, r2, torch.inf)
    return (torch.amin(r2, dim=1) <= 1.0).to(dtype)            # [B, Npix]
