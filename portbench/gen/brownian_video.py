"""A video of Brownian dimers, drawn on the device from a seed.

The scene of BASELINE.md's config 2 (``benchmarks/suite.py::_video``),
written out in torch: ``dimers`` rigid dimers of two isotropic Gaussian
features (size ``size`` px, peak ``signal``, bond ``bond`` px) with
centres uniform in the frame less a ``margin`` on every side and angles
uniform in [0, pi).  Before each frame, every centre takes a Gaussian step
of ``step`` px per axis and is clipped to [``clip``, side - ``clip``], and
every angle a Gaussian step of ``angle_step`` rad; the two features sit at
centre ± (bond / 2)·(sin, cos)(angle).  Each feature adds
``signal * exp(-r² / (2 size²))`` to the pixels of its box of ±5 sizes
(from floor(p - 5·size) to ceil(p + 5·size), as a renderer that evaluates
only that box does), then every pixel takes additive Gaussian read noise
of ``noise`` counts.  The render is one float64 product of the features'
separable profiles a frame, so a seed gives the same frames on every run
of one device.

Returns host float32 frames, as a reader from disk hands them, and the
drawn positions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CUTOFF_SIZES = 5.0


def _profiles(p, n, size, cutoff):
    """[F, n] float64 profile of each feature along one axis: its Gaussian
    on the pixels of its box, zero elsewhere."""
    g = torch.arange(n, device=p.device, dtype=torch.float64)
    d = g[None, :] - p[:, None]
    inbox = (g[None, :] >= torch.floor(p - cutoff)[:, None]) & (
        g[None, :] <= torch.ceil(p + cutoff)[:, None])
    return torch.where(inbox, torch.exp(-0.5 * (d / size) ** 2), 0.0)


def draw(videos, frames, shape, *, dimers, bond, size, signal, noise, step,
         angle_step, margin, clip, generator, device):
    """(frames [videos, frames, H, W] float32 numpy, truth [videos, frames,
    2·dimers, 2] float64 numpy: the features' (y, x), dimer k's two at
    2k and 2k + 1)."""
    H, W = shape
    hi = torch.tensor([H - 2 * margin - 1, W - 2 * margin - 1],
                      dtype=torch.float64, device=device)
    lim_hi = torch.tensor([H - clip, W - clip], dtype=torch.float64,
                          device=device)
    cutoff = CUTOFF_SIZES * size
    out = np.empty((videos, frames, H, W), np.float32)
    truth = np.empty((videos, frames, 2 * dimers, 2), np.float64)

    def normal(shape_, sigma):
        return sigma * torch.randn(shape_, generator=generator,
                                   device=device, dtype=torch.float64)

    for v in range(videos):
        center = margin + hi * torch.rand(
            (dimers, 2), generator=generator, device=device,
            dtype=torch.float64)
        angle = math.pi * torch.rand((dimers,), generator=generator,
                                     device=device, dtype=torch.float64)
        stack = torch.empty((frames, H, W), dtype=torch.float32,
                            device=device)
        for t in range(frames):
            center = torch.minimum(
                torch.clamp(center + normal((dimers, 2), step), min=clip),
                lim_hi)
            angle = angle + normal((dimers,), angle_step)
            off = (0.5 * bond) * torch.stack(
                [torch.sin(angle), torch.cos(angle)], dim=-1)
            pos = torch.stack([center + off, center - off],
                              dim=1).reshape(2 * dimers, 2)
            py = _profiles(pos[:, 0], H, size, cutoff) * signal
            px = _profiles(pos[:, 1], W, size, cutoff)
            img = py.T @ px
            stack[t] = (img + normal((H, W), noise)).to(torch.float32)
            truth[v, t] = pos.cpu().numpy()
        out[v] = stack.cpu().numpy()
    return out, truth
