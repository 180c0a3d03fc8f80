"""The dimer grid of the port's main path, drawn on the device from a seed.

A frozen torch rewrite of ``entry.example_batch`` (itself a copy of
``__graft_entry__._example_batch``): one dimer of two isotropic Gaussians
(size 2.5, separation 5, signal 150, a uniform angle) per ``pitch``² cell
of each frame, its centre jittered by ±1.5 px, its starting positions
perturbed by ±0.3 px; signal and size start at the drawn values and the
background at 0.  Each feature adds ``signal * exp(-r²/2)`` to the pixels
of its ±5 σ box, as ``artificial.draw_feature`` does.  Every pixel sums
the features of its own and the eight neighbouring cells in one fixed
order, so a seed gives the same frames on every run.
"""
from __future__ import annotations

import math

import torch


def draw(n_frames, frame_size, pitch, *, generator, device, size=2.5,
         separation=5.0, signal=150.0, center_jitter=1.5,
         start_jitter=0.3, cutoff_sigmas=5.0):
    """(frames [T, S, S] f32, frame_idx [B] i32, params0 [B, 2, 5] f32,
    truth [B, 2, 2] f32) with B = T · (S // pitch)²."""
    per_axis = frame_size // pitch
    per_frame = per_axis * per_axis
    B = n_frames * per_frame

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float64)
        return lo + (hi - lo) * u

    cell = torch.arange(B, device=device) % per_frame
    base = torch.stack([(cell // per_axis) * pitch + pitch / 2,
                        (cell % per_axis) * pitch + pitch / 2],
                       dim=-1).to(torch.float64)
    center = base + uniform((B, 2), -center_jitter, center_jitter)
    angle = uniform((B,), 0.0, math.pi)
    k = torch.arange(2, device=device, dtype=torch.float64)
    a = angle[:, None] + math.pi * k[None]                       # [B, 2]
    radius = separation / 2.0
    truth = center[:, None, :] + radius * torch.stack(
        [torch.sin(a), torch.cos(a)], dim=-1)                    # [B, 2, 2]
    start = truth + uniform((B, 2, 2), -start_jitter, start_jitter)

    params0 = torch.zeros((B, 2, 5), dtype=torch.float32, device=device)
    params0[:, :, 1] = signal
    params0[:, :, 2:4] = start.to(torch.float32)
    params0[:, :, 4] = size
    frame_idx = (torch.arange(B, device=device) // per_frame).to(torch.int32)

    # every pixel: the features of the 3 x 3 cells around its own, in the
    # order of their lane (cells row-major) and feature
    g = torch.arange(frame_size, device=device)
    feats = truth.reshape(n_frames, per_axis, per_axis, 2, 2)
    frames = torch.zeros((n_frames, frame_size, frame_size),
                         dtype=torch.float32, device=device)
    cy = (g // pitch)[:, None]
    cx = (g // pitch)[None, :]
    gy = g.to(torch.float64)[:, None]
    gx = g.to(torch.float64)[None, :]
    reach = cutoff_sigmas * size
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny, nx = cy + dy, cx + dx
            inside = (ny >= 0) & (ny < per_axis) & (nx >= 0) & (nx < per_axis)
            nyc = ny.clamp(0, per_axis - 1).expand(frame_size, frame_size)
            nxc = nx.clamp(0, per_axis - 1).expand(frame_size, frame_size)
            for f in range(2):
                p = feats[:, nyc, nxc, f]                         # [T,S,S,2]
                py, px = p[..., 0], p[..., 1]
                box = ((gy >= torch.floor(py - reach))
                       & (gy <= torch.ceil(py + reach))
                       & (gx >= torch.floor(px - reach))
                       & (gx <= torch.ceil(px + reach)) & inside)
                r2 = ((gy - py) ** 2 + (gx - px) ** 2) / (size * size)
                val = (signal * torch.exp(-0.5 * r2)).to(torch.float32)
                frames += torch.where(box, val, 0.0)
    return frames, frame_idx, params0, truth.to(torch.float32)


def perturbed(params0, count, *, generator, amount=0.05):
    """``count`` starting tables, each ``params0`` plus its own uniform
    ±``amount`` on every entry (bench.py's method: a distinct input per
    call, so no call can reuse another's result)."""
    out = []
    for _ in range(count):
        u = torch.rand(params0.shape, generator=generator,
                       device=params0.device, dtype=torch.float32)
        out.append(params0 + (2.0 * u - 1.0) * amount)
    return out
