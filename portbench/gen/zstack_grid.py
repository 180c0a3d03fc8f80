"""Confocal z-stacks of anisotropic dimers, drawn on the device from a seed.

The scene of BASELINE.md config 4 (``benchmarks/suite.py::config4``, as
``entry.example_batch_3d`` draws it), written here from its description:
one dimer of two anisotropic Gaussians (sizes (1.5, 2.2, 2.2) in (z, y,
x), separation 4.5, signal 150) per ``pitch`` cell of each stack, its
centre the cell's middle jittered by ±1 voxel on each axis, its axis in
the (y, x) plane at a uniform angle in [0, π); starts are the drawn
positions perturbed by ±0.25 voxel, signal and sizes the drawn values,
background 0.  Each feature adds ``signal * exp(-r²/2)``, r² summed over
the axes in units of the sizes, to the voxels of its ±5 σ box.  Every
voxel sums the features of its own and the 26 neighbouring cells in one
fixed order, one stack at a time, and then gains Gaussian read noise of
standard deviation ``noise`` (counts), so a seed gives the same stacks on
every run.
"""
from __future__ import annotations

import math

import torch

from gen.dimer_grid import perturbed

__all__ = ["draw", "perturbed"]


def draw(n_stacks, stack_shape, pitch, *, generator, device,
         size=(1.5, 2.2, 2.2), separation=4.5, signal=150.0,
         center_jitter=1.0, start_jitter=0.25, noise=0.0,
         cutoff_sigmas=5.0):
    """(stacks [T, Z, Y, X] f32, stack_idx [B] i32, params0 [B, 2, 8] f32,
    truth [B, 2, 3] f32) with B = T · Π (stack_shape // pitch); params0 per
    feature: (background, signal, z, y, x, size_z, size_y, size_x)."""
    per = [s // p for s, p in zip(stack_shape, pitch)]
    per_stack = per[0] * per[1] * per[2]
    B = n_stacks * per_stack

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float64)
        return lo + (hi - lo) * u

    cell = torch.arange(B, device=device) % per_stack
    idx = (cell // (per[1] * per[2]), (cell // per[2]) % per[1],
           cell % per[2])
    base = torch.stack([i * p + p / 2 for i, p in zip(idx, pitch)],
                       dim=-1).to(torch.float64)
    center = base + uniform((B, 3), -center_jitter, center_jitter)
    angle = uniform((B,), 0.0, math.pi)
    axis = (separation / 2.0) * torch.stack(
        [torch.zeros_like(angle), -torch.sin(angle), torch.cos(angle)],
        dim=-1)                                                  # [B, 3]
    truth = center[:, None, :] + torch.stack([axis, -axis], dim=1)
    start = truth + uniform((B, 2, 3), -start_jitter, start_jitter)

    params0 = torch.zeros((B, 2, 8), dtype=torch.float32, device=device)
    params0[:, :, 1] = signal
    params0[:, :, 2:5] = start.to(torch.float32)
    params0[:, :, 5:8] = torch.tensor(size, dtype=torch.float32,
                                      device=device)
    stack_idx = (torch.arange(B, device=device) // per_stack).to(torch.int32)

    # each voxel: the features of the 3 x 3 x 3 cells around its own, in
    # the order of the neighbour offsets (row-major) and of the features
    feats = truth.reshape(n_stacks, per[0], per[1], per[2], 2, 3)
    stacks = torch.zeros((n_stacks,) + tuple(stack_shape),
                         dtype=torch.float32, device=device)
    grid = [torch.arange(s, device=device) for s in stack_shape]
    shapes = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
    own = [(g // p).reshape(sh) for g, p, sh in zip(grid, pitch, shapes)]
    coord = [g.to(torch.float64).reshape(sh) for g, sh in zip(grid, shapes)]
    reach = [cutoff_sigmas * s for s in size]
    offsets = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
               for c in (-1, 0, 1)]
    for t in range(n_stacks):
        for off in offsets:
            nb = [o + k for o, k in zip(own, off)]
            inside = ((nb[0] >= 0) & (nb[0] < per[0]) & (nb[1] >= 0)
                      & (nb[1] < per[1]) & (nb[2] >= 0) & (nb[2] < per[2]))
            nbc = [c.clamp(0, m - 1).expand(*stack_shape)
                   for c, m in zip(nb, per)]
            for f in range(2):
                p = feats[t, nbc[0], nbc[1], nbc[2], f]          # [Z,Y,X,3]
                box = inside
                r2 = 0.0
                for d in range(3):
                    pd = p[..., d]
                    box = (box & (coord[d] >= torch.floor(pd - reach[d]))
                           & (coord[d] <= torch.ceil(pd + reach[d])))
                    u = (coord[d] - pd) / size[d]
                    r2 = r2 + u * u
                val = (signal * torch.exp(-0.5 * r2)).to(torch.float32)
                stacks[t] += torch.where(box, val, 0.0)
        if noise:
            stacks[t] += noise * torch.randn(
                tuple(stack_shape), generator=generator, device=device,
                dtype=torch.float32)
    return stacks, stack_idx, params0, truth.to(torch.float32)
