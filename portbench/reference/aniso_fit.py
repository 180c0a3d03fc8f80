"""Plain reference of the bucketed 3D anisotropic Gaussian cluster fit.

A cluster of ``n`` anisotropic 3D Gaussians on a held background,

    I(z, y, x) = bg + sum_i s_i exp(-sum_d (r_d - p_id)^2 / (2 sigma_id^2)),

fitted in a window around it, over the voxels within the ellipsoidal
``radius`` of any feature (sum_d ((r_d - p_id) / radius_d)^2 <= 1 at the
positions the window was cut at), by lockstep Levenberg–Marquardt inside
the refit-on-shift loop: a lane whose positions moved more than
``max_shift`` is cut out again around its new positions and solved again,
and each lane reports its best round.  Signals, positions and the three
sizes of every feature are fitted (V = 7n); the background is held.

The LM step, its damping, its stopping rules, the Cholesky solve
(``levenberg_marquardt``, ``chol_solve``) and the sums with their TF32
rounding (``Model.cost_grad_hess``, ``round_tf32``) are ``gauss_fit``'s,
imported and unchanged, and so are the
projections: positions into the stack, as there, and sizes into [0.05,
the largest window extent].  This imports nothing of the port.
``precision`` as ``gauss_fit``'s: 'float32' (the configuration's), 'tf32'
or 'bfloat16', the benchmark's control.

Departures from the paper's description (van der Wel & Kraft,
arXiv:1607.08819, which fits each cluster by its own MINPACK ``leastsq``):

- every cluster of a bucket takes its LM steps in lockstep, with
  Marquardt's diagonal damping (x4 up, x0.25 down, from 1e-3) in place of
  MINPACK's trust region, and a lane whose damping has grown 1e6-fold
  stops as converged;
- residuals are in units of the cluster's largest starting signal;
- positions and sizes are held to the bounds above, which the paper does
  not state;
- the window is fixed by the configuration (9 x 13 x 13 voxels), not by
  the cluster's extent, and the background is held at its start;
- each lane reports its best refit round, not its last.
"""
from __future__ import annotations

import torch

# TF32 and cuDNN may round float32 products below float32 on the card;
# this reference computes in the precision it is asked for
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from reference.gauss_fit import (  # noqa: E402
    PRECISIONS, Model as _Model2D, levenberg_marquardt)

D = 3
MIN_SIZE = 0.05


def window_offsets(window, device):
    """[3, Z*Y*X] float32 (z, y, x) offsets of a window's voxels."""
    axes = [torch.arange(w, device=device, dtype=torch.float32)
            for w in window]
    grids = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids])


def origins(pos, window, stack_shape):
    """[B, 3] int window corners centring each cluster's bounding box
    (rounded half to even), clamped into the stack."""
    center = 0.5 * (pos.amin(dim=1) + pos.amax(dim=1))
    w = torch.tensor(window, dtype=pos.dtype, device=pos.device)
    o = torch.round(center - 0.5 * (w - 1.0)).to(torch.int32)
    hi = torch.tensor([s - k for s, k in zip(stack_shape, window)],
                      dtype=torch.int32, device=pos.device)
    return torch.minimum(torch.clamp(o, min=0), hi)


def cut(stacks, stack_idx, origin, window):
    """[B, Z*Y*X] voxels of each lane's window."""
    Z, Y, X = stacks.shape[1:]
    dz, dy, dx = (torch.arange(w, device=stacks.device) for w in window)
    zs = origin[:, 0:1].long() + dz[None]                        # [B, wz]
    ys = origin[:, 1:2].long() + dy[None]                        # [B, wy]
    xs = origin[:, 2:3].long() + dx[None]                        # [B, wx]
    lin = ((stack_idx.long()[:, None, None, None] * Z
            + zs[:, :, None, None]) * Y + ys[:, None, :, None]) * X \
        + xs[:, None, None, :]
    return stacks.reshape(-1)[lin.reshape(len(origin), -1)]


def fit_mask(pos, origin, offsets, radius):
    """1.0 on voxels within the ellipsoidal ``radius`` of any feature."""
    rel = pos - origin[:, None, :].to(pos.dtype)                 # [B, n, 3]
    r = torch.tensor(radius, dtype=pos.dtype, device=pos.device)
    d = (offsets[None, None] - rel[..., None]) / r[:, None]      # [B,n,3,N]
    r2 = (d * d).sum(dim=2)
    return (r2.amin(dim=1) <= 1.0).to(torch.float32)


class Model(_Model2D):
    """Residual and Jacobian of one bucket of anisotropic 3D clusters;
    cost, gradient and Gauss–Newton matrix (in ``precision``) as
    ``gauss_fit.Model``'s.  The vector is [signals, z, y, x, size_z,
    size_y, size_x], n slots each."""

    def __init__(self, params0, offsets, precision):
        self.bg = params0[:, 0, 0]
        self.n = params0.shape[1]
        self.offsets = offsets
        self.norm = torch.clamp(params0[:, :, 1].abs().amax(dim=1),
                                min=1e-6)
        self.precision = precision
        self.dtype = (torch.bfloat16 if precision == "bfloat16"
                      else torch.float32)

    def split(self, x):
        """(signals [B, n], positions [B, n, 3], sizes [B, n, 3])."""
        n = self.n
        pos = torch.stack([x[:, (1 + d) * n:(2 + d) * n] for d in range(D)],
                          dim=-1)
        size = torch.stack([x[:, (4 + d) * n:(5 + d) * n] for d in range(D)],
                           dim=-1)
        return x[:, :n], pos, size

    def residual_jac(self, x, pixels, mask, origin):
        """(r [B, N], J [B, 7n, N]) at ``x``."""
        dt = self.dtype
        sig, pos, size = (t.to(dt) for t in self.split(x))
        rel = pos - origin[:, None, :].to(dt)
        dx = self.offsets.to(dt)[None, None] - rel[..., None]    # [B,n,3,N]
        dxs = dx / size[..., None]
        r2 = (dxs * dxs).sum(dim=2)                              # [B, n, N]
        f = torch.exp(-0.5 * r2)
        img = self.bg.to(dt)[:, None] + (sig[:, :, None] * f).sum(dim=1)
        w = mask.to(dt) / self.norm.to(dt)[:, None]
        r = (img - pixels.to(dt)) * w
        # d img / d p_d = s f dxs_d / sigma_d; d img / d sigma_d =
        # s f dxs_d^2 / sigma_d
        sfw = sig[:, :, None] * f * w[:, None]
        cols = [f * w[:, None]]
        cols += [sfw * dxs[:, :, d] / size[:, :, d, None] for d in range(D)]
        cols += [sfw * dxs[:, :, d] * dxs[:, :, d] / size[:, :, d, None]
                 for d in range(D)]
        return r.float(), torch.cat(cols, dim=1).float()


def fit(stacks, stack_idx, params0, valid, *, window, radius, max_iter=10,
        max_shift=1.0, lm_max_iter=60, ftol=1.49e-8, xtol=1.49e-8,
        precision="float32"):
    """Fit every valid lane of a bucket.

    ``stacks`` [T, Z, Y, X]; ``params0`` [B, n, 8] = (background, signal,
    z, y, x, size_z, size_y, size_x) per feature.  Returns a dict:
    ``params`` [B, n, 8], ``rms`` [B] (sqrt of the cost over the fitted
    voxels, residuals in units of the largest starting signal),
    ``converged`` [B], ``iters`` [B] (LM iterations over every round), and
    ``rounds``: per refit round the lanes solved (``need``), their LM
    iterations and fitted voxels, which fix the work a solver of these
    inputs has to do."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    dev = stacks.device
    B, n, _ = params0.shape
    shape = tuple(stacks.shape[1:])
    offsets = window_offsets(window, dev)
    model = Model(params0, offsets, precision)
    lo = torch.full((7 * n,), -torch.inf, device=dev)
    hi = torch.full((7 * n,), torch.inf, device=dev)
    for d in range(D):
        lo[(1 + d) * n:(2 + d) * n] = 0.0
        hi[(1 + d) * n:(2 + d) * n] = float(shape[d] - 1)
    lo[4 * n:] = MIN_SIZE
    hi[4 * n:] = float(max(window))
    x = torch.cat([params0[:, :, 1]]
                  + [params0[:, :, 2 + k] for k in range(2 * D)], dim=1)
    need = valid.clone()
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    x_best = x
    rms_best = torch.full((B,), torch.inf, device=dev)
    conv_best = torch.zeros(B, dtype=torch.bool, device=dev)
    rounds = []
    for it in range(max(max_iter, 1)):
        if it > 0 and not bool(need.any()):
            break
        pos = model.split(x)[1]
        origin = origins(pos, window, shape)
        pixels = cut(stacks, stack_idx, origin, window)
        mask = fit_mask(pos, origin, offsets, radius)
        xr, cost, n_iter, conv = levenberg_marquardt(
            model, x, (pixels, mask, origin), lo, hi, need, lm_max_iter,
            ftol, xtol)
        npix = mask.sum(dim=1)
        rounds.append(dict(need=need.clone(), n_iter=n_iter, npix=npix))
        shift = (model.split(xr)[1] - pos).abs().amax(dim=(1, 2))
        rms = torch.where(npix > 0,
                          torch.sqrt(cost / torch.clamp(npix, min=1.0)),
                          torch.inf)
        iters = iters + torch.where(need, n_iter, 0)
        better = need & (rms < rms_best)
        x_best = torch.where(better[:, None], xr, x_best)
        rms_best = torch.where(better, rms, rms_best)
        conv_best = torch.where(better, conv, conv_best)
        need = need & (shift > max_shift)
        x = xr
    sig, pos, size = model.split(x_best)
    params = params0.clone()
    params[:, :, 1] = sig
    params[:, :, 2:5] = pos
    params[:, :, 5:8] = size
    return dict(params=params, rms=rms_best, converged=conv_best,
                iters=iters, rounds=rounds)
