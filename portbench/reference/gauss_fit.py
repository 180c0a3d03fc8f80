"""Plain reference of the bucketed 2D Gaussian cluster fit.

A cluster of ``n`` isotropic 2D Gaussians on a constant background,

    I(y, x) = bg + sum_i s_i exp(-((y - y_i)^2 + (x - x_i)^2) / (2 size_i^2)),

fitted in a window around it, over the pixels within ``radius`` of any
feature, by lockstep Levenberg–Marquardt (Marquardt damping, MINPACK's
ftol/xtol, positions projected into the frame), inside the refit-on-shift
loop: a lane whose positions moved more than ``max_shift`` is cut out again
around its new positions and solved again, and each lane reports its best
round.  Signals and positions are fitted; background and size are held.

This is the semantics of the port's bucket solver written out in plain
PyTorch with no kernel, no cache and no batching trick.  It imports
nothing of the port.  ``precision`` selects the arithmetic of the sums:
'float32' (the configuration's), 'tf32' (the operands of every sum over
pixels rounded to TF32's 10-bit mantissa, products accumulated in
float32, as a tensor core in TF32 does) or 'bfloat16' (the model, the
residual and the Jacobian in bfloat16, accumulated in float32).  The two
lower ones serve as the benchmark's control.
"""
from __future__ import annotations

import torch

LAM0, LAM_UP, LAM_DOWN, LAM_MAX = 1e-3, 4.0, 0.25, 1e10
PRECISIONS = ("float32", "tf32", "bfloat16")


def round_tf32(x):
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    out = ((bits + bias) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def window_offsets(window, device):
    """[2, H*W] float32 (row, col) offsets of a window's pixels."""
    iy = torch.arange(window[0], device=device, dtype=torch.float32)
    ix = torch.arange(window[1], device=device, dtype=torch.float32)
    gy, gx = torch.meshgrid(iy, ix, indexing="ij")
    return torch.stack([gy.reshape(-1), gx.reshape(-1)])


def origins(pos, window, frame_shape):
    """[B, 2] int window corners centring each cluster's bounding box
    (rounded half to even), clamped into the frame."""
    center = 0.5 * (pos.amin(dim=1) + pos.amax(dim=1))
    w = torch.tensor(window, dtype=pos.dtype, device=pos.device)
    o = torch.round(center - 0.5 * (w - 1.0)).to(torch.int32)
    hi = torch.tensor([frame_shape[0] - window[0], frame_shape[1] - window[1]],
                      dtype=torch.int32, device=pos.device)
    return torch.minimum(torch.clamp(o, min=0), hi)


def cut(frames, frame_idx, origin, window):
    """[B, H*W] pixels of each lane's window."""
    H, W = frames.shape[1:]
    dy = torch.arange(window[0], device=frames.device)
    dx = torch.arange(window[1], device=frames.device)
    rows = origin[:, 0:1].long() + dy[None]                  # [B, h]
    cols = origin[:, 1:2].long() + dx[None]                  # [B, w]
    lin = (frame_idx.long()[:, None, None] * H + rows[:, :, None]) * W \
        + cols[:, None, :]
    return frames.reshape(-1)[lin.reshape(len(origin), -1)]


def fit_mask(pos, origin, offsets, radius):
    """1.0 on pixels within ``radius`` (per axis) of any real feature."""
    rel = pos - origin[:, None, :].to(pos.dtype)                 # [B, n, 2]
    r = torch.tensor(radius, dtype=pos.dtype, device=pos.device)
    d = (offsets[None, None] - rel[..., None]) / r[:, None]      # [B,n,2,N]
    r2 = (d * d).sum(dim=2)
    return (r2.amin(dim=1) <= 1.0).to(torch.float32)


class Model:
    """Residual and Jacobian of one bucket (window, constants, norm)."""

    def __init__(self, params0, offsets, precision):
        self.bg = params0[:, 0, 0]
        self.size = params0[:, :, 4]
        self.n = params0.shape[1]
        self.offsets = offsets
        self.norm = torch.clamp(params0[:, :, 1].abs().amax(dim=1),
                                min=1e-6)
        self.precision = precision
        self.dtype = (torch.bfloat16 if precision == "bfloat16"
                      else torch.float32)

    def split(self, x):
        n = self.n
        return x[:, :n], torch.stack([x[:, n:2 * n], x[:, 2 * n:]], dim=-1)

    def residual_jac(self, x, pixels, mask, origin):
        """(r [B, N], J [B, 3n, N]) at ``x`` = [signals, ys, xs]."""
        dt = self.dtype
        sig, pos = self.split(x)
        sig, pos = sig.to(dt), pos.to(dt)
        rel = pos - origin[:, None, :].to(dt)
        dx = self.offsets.to(dt)[None, None] - rel[..., None]    # [B,n,2,N]
        dxs = dx / self.size.to(dt)[:, :, None, None]
        r2 = (dxs * dxs).sum(dim=2)                              # [B, n, N]
        f = torch.exp(-0.5 * r2)
        img = self.bg.to(dt)[:, None] + (sig[:, :, None] * f).sum(dim=1)
        w = mask.to(dt) / self.norm.to(dt)[:, None]
        r = (img - pixels.to(dt)) * w
        sig_df = sig[:, :, None] * (-0.5 * f)
        size = self.size.to(dt)[:, :, None]
        cols = [f * w[:, None]]
        for d in range(2):
            cols.append(sig_df * (-2.0) * dxs[:, :, d] / size * w[:, None])
        J = torch.cat(cols, dim=1)                               # [B, 3n, N]
        return r.float(), J.float()

    def cost_grad_hess(self, x, pixels, mask, origin):
        r, J = self.residual_jac(x, pixels, mask, origin)
        if self.precision == "tf32":
            r, J = round_tf32(r), round_tf32(J)
        g = torch.einsum("bvn,bn->bv", J, r)
        H = torch.einsum("bun,bvn->buv", J, J)
        return (r * r).sum(dim=-1), g, H


def chol_solve(A, g):
    """Batched SPD solve, Cholesky written out, pivots clamped at 1e-20."""
    V = A.shape[-1]
    L = [[None] * V for _ in range(V)]
    for j in range(V):
        s = A[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-20))
        L[j][j] = d
        for i in range(j + 1, V):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / d
    y = [None] * V
    for i in range(V):
        s = g[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    out = [None] * V
    for i in reversed(range(V)):
        s = y[i]
        for k in range(i + 1, V):
            s = s - L[k][i] * out[k]
        out[i] = s / L[i][i]
    return torch.stack(out, dim=-1)


def levenberg_marquardt(model, x0, args, lo, hi, active, max_iter, ftol,
                        xtol):
    """Lockstep LM over the lanes of ``active``: (x, cost, n_iter,
    converged)."""
    B, V = x0.shape
    dev = x0.device
    eye = torch.eye(V, device=dev)

    def clip(x):
        return torch.minimum(torch.maximum(x, lo), hi)

    x = clip(x0)
    cost, g, H = model.cost_grad_hess(x, *args)
    lam = torch.full((B,), LAM0, device=dev)
    active = active.clone()
    n_iter = torch.zeros(B, dtype=torch.int32, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        d = torch.where(d > 1e-12, d, 1e-12)
        A = H + (lam[:, None] * d)[:, None, :] * eye + 1e-10 * eye
        x_try = clip(x - chol_solve(A, g))
        step = x_try - x
        c_try, g_try, H_try = model.cost_grad_hess(x_try, *args)
        accept = active & (c_try < cost)
        lam_new = torch.where(accept, lam * LAM_DOWN,
                              torch.clamp(lam * LAM_UP, max=LAM_MAX))
        lam_new = torch.where(active, lam_new, lam)
        xnorm = x.abs().amax(dim=-1)
        snorm = step.abs().amax(dim=-1)
        conv_now = (accept & (snorm <= xtol * (xtol + xnorm))) | (
            accept & ((cost - c_try) <= ftol * torch.clamp(cost, min=1e-30)))
        cost_new = torch.where(accept, c_try, cost)
        conv_now = conv_now | ((lam_new >= 1e6 * LAM0)
                               & torch.isfinite(cost_new))
        done = active & (conv_now | (lam_new >= LAM_MAX))
        x = torch.where(accept[:, None], x_try, x)
        g = torch.where(accept[:, None], g_try, g)
        H = torch.where(accept[:, None, None], H_try, H)
        n_iter = n_iter + active.to(torch.int32)
        conv = conv | (active & conv_now)
        active = active & ~done
        cost, lam = cost_new, lam_new
    return x, cost, n_iter, conv


def fit(frames, frame_idx, params0, valid, *, window, radius, max_iter=10,
        max_shift=1.0, lm_max_iter=60, ftol=1.49e-8, xtol=1.49e-8,
        precision="float32"):
    """Fit every valid lane of a bucket.

    ``params0`` [B, n, 5] = (background, signal, y, x, size) per feature.
    Returns a dict: ``params`` [B, n, 5], ``rms`` [B] (sqrt of the cost
    over the fitted pixels, residuals in units of the largest starting
    signal), ``converged`` [B], ``iters`` [B] (LM iterations over every
    round), and ``rounds``: per refit round the lanes solved (``need``),
    their LM iterations and fitted pixels, which fix the work a solver
    of these inputs has to do."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    dev = frames.device
    B, n, _ = params0.shape
    frame_shape = tuple(frames.shape[1:])
    offsets = window_offsets(window, dev)
    model = Model(params0, offsets, precision)
    V = 3 * n
    lo = torch.full((V,), -torch.inf, device=dev)
    hi = torch.full((V,), torch.inf, device=dev)
    lo[n:] = 0.0
    hi[n:2 * n] = float(frame_shape[0] - 1)
    hi[2 * n:] = float(frame_shape[1] - 1)
    x = torch.cat([params0[:, :, 1], params0[:, :, 2], params0[:, :, 3]],
                  dim=1)
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
        origin = origins(pos, window, frame_shape)
        pixels = cut(frames, frame_idx, origin, window)
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
    sig, pos = model.split(x_best)
    params = params0.clone()
    params[:, :, 1] = sig
    params[:, :, 2:4] = pos
    return dict(params=params, rms=rms_best, converged=conv_best,
                iters=iters, rounds=rounds)
