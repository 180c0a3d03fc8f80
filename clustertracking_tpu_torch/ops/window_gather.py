"""Per-cluster window gather from a 2D or 3D frame stack: the CUDA kernel
and its plain version.

Counterpart of ``clustertracking_tpu/ops/pallas_gather.py``, whose
``make_pallas_gather`` kernel cuts each cluster's window out of the frame
stack for the buckets the fused 2D kernel does not take (3D above all).

- ``window_gather`` is the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/window_gather.cu`` (built for sm_90a on first
  use) and counts the launch in ``window_gather.launches``; on CPU tensors
  it returns the plain version's result.  It raises on anything the
  kernel does not take, and never swaps in the plain version for a CUDA
  tensor.
- The plain version is ``ops/gather.py::gather_stack``.  The kernel is a
  copy, so the two agree bit for bit.

Both take ``frames [T, *S] f32, frame_idx [B] i32, origin [B, D] i32``
(origins already clamped, ``ops/gather.py::origins_for``) and the window
shape, and return ``pixels [B, Npix] f32`` in raster (z, y, x) order.  On
CUDA a lane whose frame index or window lies outside the stack gets a row
of NaN.
"""
from __future__ import annotations

import ctypes

import torch

from .gather import gather_stack

__all__ = ["window_gather"]

_ARGTYPES = (
    [ctypes.c_void_p] + [ctypes.c_int] * 4      # frames, T, Z, H, W
    + [ctypes.c_void_p] * 2                     # frame_idx, origin
    + [ctypes.c_int] * 5                        # B, D, wz, wy, wx
    + [ctypes.c_void_p] * 2                     # out, stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("window_gather")
    if lib.window_gather_launch.argtypes is None:
        lib.window_gather_launch.argtypes = _ARGTYPES
        lib.window_gather_launch.restype = ctypes.c_int
    return lib


def check_tensor(who, name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if t.shape != tuple(shape):
        raise ValueError(
            f"{who}: {name} has shape {tuple(t.shape)}, "
            f"expected {tuple(shape)}"
        )
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def window_gather(frames, frame_idx, origin, window_shape):
    """Gather [B, Npix] windows (see the module docstring).

    CUDA tensors launch ``csrc/window_gather.cu``; CPU tensors get
    ``gather_stack``."""
    window_shape = tuple(map(int, window_shape))
    device = frames.device
    if device.type == "cpu":
        return gather_stack(frames, frame_idx, origin, window_shape)
    if device.type != "cuda":
        raise ValueError(f"window_gather: unsupported device {device}")
    D = len(window_shape)
    if D not in (2, 3) or frames.dim() != D + 1:
        raise ValueError(
            f"window_gather: a {D}D window needs frames [T, *S] of rank "
            f"{D + 1}, got {tuple(frames.shape)}"
        )
    S = tuple(frames.shape[1:])
    if any(w < 1 or w > s for w, s in zip(window_shape, S)):
        raise ValueError(f"window_gather: window {window_shape} does not "
                         f"fit frames {S}")
    B = frame_idx.shape[0]
    check_tensor("window_gather", "frames", frames, torch.float32,
                 frames.shape, device)
    check_tensor("window_gather", "frame_idx", frame_idx, torch.int32, (B,),
                 device)
    check_tensor("window_gather", "origin", origin, torch.int32, (B, D),
                 device)
    npix = 1
    for w in window_shape:
        npix *= w
    out = torch.empty((B, npix), dtype=torch.float32, device=device)
    if B == 0:
        return out
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        with torch.cuda.device(index):
            rc = _launch(frames, frame_idx, origin, window_shape, out)
    else:
        rc = _launch(frames, frame_idx, origin, window_shape, out)
    if rc != 0:
        raise RuntimeError(f"window_gather: kernel launch failed, "
                           f"cudaError {rc}")
    window_gather.launches += 1
    return out


def _launch(frames, frame_idx, origin, window_shape, out):
    """The kernel's launch on the current device's current stream, on
    tensors ``window_gather`` has checked; returns the launcher's code."""
    D = len(window_shape)
    Z, H, W = (1,) + tuple(frames.shape[1:]) if D == 2 else frames.shape[1:]
    wz, wy, wx = (1,) + window_shape if D == 2 else window_shape
    return _library().window_gather_launch(
        frames.data_ptr(), frames.shape[0], Z, H, W, frame_idx.data_ptr(),
        origin.data_ptr(), frame_idx.shape[0], D, wz, wy, wx,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)


window_gather.launches = 0
