"""The device an entry point runs on."""
from __future__ import annotations

import torch


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
