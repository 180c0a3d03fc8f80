"""Synthetic frame rendering on a device.

Counterpart of ``clustertracking_tpu/ops/synth.py``: the feature table
(positions, signals, sizes, frame of each feature) is rasterized straight
into a frame stack on the device, as ``artificial.CoordinateReader`` does
on the host.  ``track``'s recovery passes render the accepted fits with it
and subtract them from the frames (``pipeline._ResidualReader``).

Each feature evaluates its profile on a fixed ``window``-shaped grid
anchored at ``floor(pos) - window // 2``; pixels outside the frame get the
value 0 and the index of a guard cell past the stack, so they never land
on an edge pixel.  The windows are summed into the flat stack
deterministically: the values are sorted by pixel (a stable sort keeps
each pixel's contributions in feature order) and each pixel's run is
added up in that order in float32, all pixels a term at a time, as the
reference's scatter-add adds them on a CPU.  A scatter-add with atomics
(``index_add_``) would add in an order that changes from run to run on a
GPU, and so would a float prefix sum (``cumsum``), and with either the
last bits of every frame.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.registry import get_model
from ..utils import default_pos_columns, validate_tuple
from ..utils.device import _resolve_device

__all__ = ["render_frames", "frames_from_df"]


def _pixel_sums(flat_idx, vals, total):
    """``out[i] = sum of vals[flat_idx == i]`` for i < total (the guard
    cell, index ``total``, is dropped), in float32 and the same bits on
    every run: a stable sort by pixel, then each pixel's run added up in
    feature order, one term a step for every pixel at once (as many
    steps as the most features on one pixel)."""
    inside = flat_idx < total                  # the guard cell adds 0
    idx_s, order = torch.sort(flat_idx[inside], stable=True)
    v = vals[inside][order]
    n = idx_s.numel()
    out = torch.zeros(total, dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    first = torch.ones(n, dtype=torch.bool, device=vals.device)
    first[1:] = idx_s[1:] != idx_s[:-1]
    starts = torch.nonzero(first).squeeze(1)
    counts = torch.diff(starts, append=starts.new_tensor([n]))
    acc = v[starts]
    for k in range(1, int(counts.max())):
        take = torch.clamp(starts + k, max=n - 1)
        acc = acc + torch.where(counts > k, v[take], 0.0)
    out[idx_s[starts].long()] = acc
    return out


def render_frames(
    positions,
    signals,
    sizes,
    frame_idx,
    n_frames: int,
    shape: Tuple[int, ...],
    fit_function="gauss",
    window: Optional[Tuple[int, ...]] = None,
    extras=(),
    noise_level: float = 0.0,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """Render a float32 frame stack [n_frames, *shape] from a feature table.

    Args:
      positions: [N, D] — feature centers (pixel coordinates).
      signals: [N] — peak amplitudes.
      sizes: [N, D] (or [N] isotropic) — per-axis sigmas.
      frame_idx: [N] int — the frame each feature lands in.
      n_frames, shape: the output's geometry.
      fit_function: a registry profile name ('gauss', 'ring', 'hat',
        'disc', ...) or a ``ModelSpec``.
      window: per-axis extent evaluated around each feature (required;
        ``frames_from_df`` derives it from the size).
      extras: extra profile parameters, scalars or [N] arrays, in the
        model's ``extra_params`` order (``(thickness,)`` for 'ring').
      noise_level: std of Gaussian noise added per pixel (0 = none), drawn
        from a ``torch.Generator`` on ``device`` seeded with ``seed``.
      device: None is 'cuda' (``RuntimeError`` where there is none); pass
        ``device='cpu'`` to render on the host.

    Matches ``artificial.draw_spots`` within the window's truncation tail
    (~exp(-12.5)·signal for a ±5σ Gaussian window).  The noise is not the
    reference's values (JAX's random stream), only their distribution.
    """
    if window is None:
        raise ValueError(
            "window is required; use frames_from_df or pass "
            "window=ceil(10*max_size)+1 per axis"
        )
    device = _resolve_device(device, "render_frames")
    model = get_model(fit_function)

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a, np.float32),
                            device=device)

    pos = f32(positions)
    sig = f32(signals)
    size = f32(sizes)
    fidx = torch.tensor(np.ascontiguousarray(frame_idx, np.int64),
                        device=device)
    N, D = pos.shape
    if size.dim() == 1:
        size = size[:, None].expand(N, D)
    window = tuple(int(w) for w in window)
    shape = tuple(int(s) for s in shape)
    ex = [torch.broadcast_to(f32(e), (N,)).reshape((N,) + (1,) * D)
          for e in extras]
    frame_px = int(np.prod(shape))
    total = int(n_frames) * frame_px
    idx_dtype = torch.int32 if total < 2 ** 31 - 1 else torch.int64

    corner = torch.floor(pos).to(torch.int64) - torch.tensor(
        [w // 2 for w in window], device=device)
    r2 = None
    ok = None
    flat = (fidx * frame_px).reshape((N,) + (1,) * D)
    stride = frame_px
    for d in range(D):
        stride //= shape[d]
        view = [1] * (D + 1)
        view[0] = N
        off = torch.arange(window[d], device=device)
        view_w = [1] * (D + 1)
        view_w[d + 1] = window[d]
        coord = corner[:, d].reshape(view) + off.reshape(view_w)
        dx = (coord.to(torch.float32) - pos[:, d].reshape(view)) \
            / size[:, d].reshape(view)
        r2 = dx * dx if r2 is None else r2 + dx * dx
        inb = (coord >= 0) & (coord < shape[d])
        ok = inb if ok is None else ok & inb
        flat = flat + torch.clamp(coord, 0, shape[d] - 1) * stride
    vals = sig.reshape((N,) + (1,) * D) * model.fun(r2, *ex)
    flat = torch.where(ok, flat, total)
    vals = torch.where(ok, vals, torch.zeros((), device=device))
    out = _pixel_sums(flat.reshape(-1).to(idx_dtype), vals.reshape(-1),
                      total).reshape((int(n_frames),) + shape)
    if noise_level > 0.0:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        out = out + noise_level * torch.randn(
            out.shape, generator=g, device=device)
    return out


def frames_from_df(
    f,
    shape: Sequence[int],
    size,
    n_frames: Optional[int] = None,
    fit_function="gauss",
    signal_col: str = "signal",
    t_column: str = "frame",
    pos_columns: Optional[list] = None,
    noise_level: float = 0.0,
    seed: int = 0,
    cutoff_sigmas: float = 5.0,
    device=None,
) -> torch.Tensor:
    """The frame stack [n_frames, *shape] of a coordinate DataFrame,
    rendered on ``device`` (None: 'cuda', as ``render_frames``): the
    device counterpart of ``artificial.CoordinateReader`` for a whole
    stack at once.  ``size`` is one sigma per axis (or a scalar); each
    feature is evaluated on a window of ±``cutoff_sigmas``·size."""
    ndim = len(shape)
    if pos_columns is None:
        pos_columns = default_pos_columns(ndim)
    if n_frames is None:
        n_frames = int(f[t_column].max()) + 1 if len(f) else 0
    size_t = np.asarray(validate_tuple(size, ndim), dtype=np.float32)
    window = tuple(
        min(int(np.ceil(2 * cutoff_sigmas * s)) + 1, int(dim))
        for s, dim in zip(size_t, shape)
    )
    positions = f[pos_columns].to_numpy(dtype=np.float32)
    N = len(f)
    signals = (
        f[signal_col].to_numpy(dtype=np.float32)
        if signal_col in f.columns else np.ones(N, np.float32)
    )
    sizes = np.broadcast_to(size_t, (N, ndim))
    fidx = f[t_column].to_numpy(dtype=np.int32)
    return render_frames(
        positions, signals, sizes, fidx, int(n_frames), tuple(shape),
        fit_function=fit_function, window=window,
        noise_level=float(noise_level), seed=seed, device=device,
    )
