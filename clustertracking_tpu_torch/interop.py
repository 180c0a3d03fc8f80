"""Carry the JAX reference's state into the port.

The reference hands its bucket solver numpy-convertible arrays (numpy or
``jax.Array``); ``from_reference`` turns them into the port's tensors on
an explicit device, with the dtypes the port's solvers take.  It needs
no JAX: ``np.asarray`` reads a ``jax.Array`` through the array protocol.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .models.packing import MODE_CODES

__all__ = ["ReferenceState", "from_reference"]


class ReferenceState(NamedTuple):
    frames: torch.Tensor               # [T, *S] f32
    frame_idx: torch.Tensor            # [B] i32
    params0: torch.Tensor              # [B, n, P] f32
    pose0: torch.Tensor                # [B, Q] f32
    valid: torch.Tensor                # [B] bool
    fvalid: Optional[torch.Tensor]     # [B, n] f32 or None
    slot_idx: Optional[torch.Tensor]   # [n, P] i32, -1 = const
    mode_masks: Optional[dict]         # mode -> [P] bool


def from_reference(frames, frame_idx, params0, pose0, valid, fvalid=None,
                   layout=None, *, device) -> ReferenceState:
    """Tensors on ``device`` from the reference's bucket-solver inputs.

    ``layout`` (a reference or port ``ParamLayout``, optional) adds its
    ``slot_idx`` and one [P] bool mask per fitting mode."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    slot_idx = mode_masks = None
    if layout is not None:
        slot_idx = t(layout.slot_idx, torch.int32)
        modes = np.asarray(layout.modes)
        mode_masks = {
            m: torch.as_tensor(modes == m, device=device) for m in MODE_CODES
        }
    return ReferenceState(
        frames=t(frames, torch.float32),
        frame_idx=t(frame_idx, torch.int32),
        params0=t(params0, torch.float32),
        pose0=t(pose0, torch.float32),
        valid=t(valid, torch.bool),
        fvalid=None if fvalid is None else t(fvalid, torch.float32),
        slot_idx=slot_idx,
        mode_masks=mode_masks,
    )
