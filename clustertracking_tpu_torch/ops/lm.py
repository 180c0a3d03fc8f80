"""Batched masked Levenberg–Marquardt in PyTorch.

Counterpart of ``clustertracking_tpu/ops/lm.py::lm_solve``.  Thousands of
independent small least-squares problems run in *lockstep*:

- every lane (cluster) shares the same shapes (bucketing upstream);
- converged lanes freeze (their state stops updating);
- damping is Marquardt's, λ·max(diag(JᵀJ), 1e-12) plus a 1e-10·I floor;
- box bounds are handled by projecting the trial point.

ftol/xtol default to scipy.optimize.leastsq's 1.49e-8.  The loop is a
Python loop that stops when no lane is active (one host sync per
iteration).  ``lm_solve_global`` is the counterpart of the reference's
function of that name: the same lockstep solve with 'global' slots tied
across the batch.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

__all__ = ["LMResult", "damped_solve", "lm_solve", "lm_solve_global"]


class LMResult(NamedTuple):
    x: torch.Tensor          # [B, V] solution
    cost: torch.Tensor       # [B] final sum of squared residuals
    n_iter: torch.Tensor     # [B] iterations taken (int32)
    converged: torch.Tensor  # [B] bool — hit ftol/xtol/plateau
    # masked-pixel count per lane; filled by the fused solver, which owns
    # the fit mask — None from lm_solve
    npix: Optional[torch.Tensor] = None


def _chol_solve_unrolled(A, g):
    """Batched SPD solve by a Cholesky written out over V, on [B] tensors.

    The pivot is clamped, ``sqrt(max(s, 1e-20))``, so an ill-conditioned
    lane gives a finite (rejected) step — the same arithmetic as the
    reference's unrolled form and the CUDA kernel."""
    V = A.shape[-1]
    L = [[None] * V for _ in range(V)]
    for j in range(V):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-20))
        L[j][j] = d
        for i in range(j + 1, V):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / d
    y = [None] * V
    for i in range(V):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * V
    for i in reversed(range(V)):
        s = y[i]
        for k in range(i + 1, V):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


# Above this many slots the damped solve uses the library Cholesky: the
# written-out form costs ~V³/6 tensor ops per solve.
_UNROLL_MAX_V = 20


def damped_solve(H, g, lam):
    """Solve (H + lam*max(diag(H), 1e-12) + 1e-10*I) delta = -g, batched."""
    V = H.shape[-1]
    eye = torch.eye(V, dtype=H.dtype, device=H.device)
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    d = torch.where(d > 1e-12, d, 1e-12)
    A = H + (lam[..., None] * d)[..., None, :] * eye
    A = A + 1e-10 * eye
    if V <= _UNROLL_MAX_V:
        return -_chol_solve_unrolled(A, g)
    # A lane whose A is not positive definite gets NaN (info != 0), so its
    # trial cost is NaN and the step is rejected — what JAX's Cholesky does;
    # torch.linalg.cholesky would raise instead.
    L, info = torch.linalg.cholesky_ex(A)
    delta = -torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info == 0)[..., None], delta, torch.nan)


def lm_solve(
    residual_fn: Callable,
    residual_jac_fn: Callable,
    x0: torch.Tensor,
    args: Tuple = (),
    *,
    max_iter: int = 50,
    ftol: float = 1.49e-8,
    xtol: float = 1.49e-8,
    lam0: float = 1e-3,
    lam_up: float = 4.0,
    lam_down: float = 0.25,
    lam_max: float = 1e10,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> LMResult:
    """Run lockstep LM on a batch of independent least-squares problems.

    Args:
      residual_fn: ``f(x, *args) -> r [B, N]`` (kept for signature parity
        with the reference; every sweep uses ``residual_jac_fn``).
      residual_jac_fn: ``f(x, *args) -> (r [B, N], J [B, V, N])``.
      x0: [B, V] initial guesses.
      args: extra tensors forwarded to the residual functions.
      lower/upper: optional [V] or [B, V] box bounds (projected steps).
      valid: optional [B] bool — padding lanes (False) are never updated.
    """
    del residual_fn
    B, V = x0.shape
    dtype = x0.dtype
    if valid is None:
        valid = torch.ones((B,), dtype=torch.bool, device=x0.device)

    def clip(x):
        if lower is not None:
            x = torch.maximum(x, lower)
        if upper is not None:
            x = torch.minimum(x, upper)
        return x

    def cost_grad_hess(x):
        """ONE residual+Jacobian sweep → (cost, g, H)."""
        r, J = residual_jac_fn(x, *args)
        g = torch.einsum("bvn,bn->bv", J, r)
        H = torch.einsum("bun,bvn->buv", J, J)
        return torch.sum(r * r, dim=-1), g, H

    x = clip(x0)
    # (cost, g, H) are evaluated at the TRIAL point and carried: on
    # acceptance they become the current state, on rejection the carried
    # values are reused — one sweep per iteration.
    cost, g, H = cost_grad_hess(x)
    lam = torch.full((B,), lam0, dtype=dtype, device=x0.device)
    active = valid.clone()
    n_iter = torch.zeros((B,), dtype=torch.int32, device=x0.device)
    converged = torch.zeros((B,), dtype=torch.bool, device=x0.device)

    for _ in range(max_iter):
        if not bool(active.any()):
            break
        delta = damped_solve(H, g, lam)
        x_trial = clip(x + delta)
        step = x_trial - x
        c_trial, g_trial, H_trial = cost_grad_hess(x_trial)
        better = c_trial < cost

        accept = active & better
        x_new = torch.where(accept[:, None], x_trial, x)
        cost_new = torch.where(accept, c_trial, cost)
        g = torch.where(accept[:, None], g_trial, g)
        H = torch.where(accept[:, None, None], H_trial, H)
        lam_new = torch.where(
            accept, lam * lam_down, torch.clamp(lam * lam_up, max=lam_max)
        )
        lam_new = torch.where(active, lam_new, lam)

        # ftol/xtol on accepted steps (MINPACK semantics), or a plateau —
        # no improving step across ~6 orders of damping.
        xnorm = torch.amax(torch.abs(x), dim=-1)
        snorm = torch.amax(torch.abs(step), dim=-1)
        conv_x = accept & (snorm <= xtol * (xtol + xnorm))
        conv_f = accept & (
            (cost - c_trial) <= ftol * torch.clamp(cost, min=1e-30)
        )
        plateau = (lam_new >= 1e6 * lam0) & torch.isfinite(cost_new)
        stuck = lam_new >= lam_max  # diverged / non-finite: freeze only
        conv_now = conv_x | conv_f | plateau
        newly_done = active & (conv_now | stuck)

        n_iter = n_iter + active.to(torch.int32)
        converged = converged | (active & conv_now)
        active = active & ~newly_done
        x, cost, lam = x_new, cost_new, lam_new

    return LMResult(x=x, cost=cost, n_iter=n_iter, converged=converged)


def lm_solve_global(
    residual_fn: Callable,
    residual_jac_fn: Callable,
    x0: torch.Tensor,
    global_slots,
    args: Tuple = (),
    *,
    max_iter: int = 50,
    ftol: float = 1.49e-8,
    xtol: float = 1.49e-8,
    lam0: float = 1e-3,
    lam_up: float = 4.0,
    lam_down: float = 0.25,
    lam_max: float = 1e10,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> LMResult:
    """LM with the slots flagged in ``global_slots`` ([V] bool) tied across
    the valid lanes (train_leastsq, and 'global' parameter modes).

    Per-lane slots stay independent.  A global slot is the mean over valid
    lanes after every update, projected into the bounds; its gradient and
    Hessian block are summed over lanes (residuals and Jacobians weighted
    by ``valid``), divided by the number of valid lanes and broadcast back,
    so every lane solves its own system with the shared block.  One scalar
    damping factor drives all lanes, so the joint cost is monotone, and the
    ftol/xtol/plateau exits are joint.

    Per lane, ``n_iter`` is the last iteration at which the lane's own
    (non-global) slots moved by more than max(xtol·(xtol + |x|),
    1e-6·|x|), and ``converged`` is the joint flag or'ed with "stopped
    moving before the loop ended"; ``cost`` is the lane's own sum of
    squares at the solution (one more ``residual_fn`` evaluation).
    """
    B, V = x0.shape
    dtype, device = x0.dtype, x0.device
    gmask = torch.as_tensor(list(map(bool, global_slots)), dtype=torch.bool,
                            device=device)
    if valid is None:
        valid = torch.ones((B,), dtype=torch.bool, device=device)
    w = valid.to(dtype)
    nvalid = torch.clamp(torch.sum(w), min=1.0)
    share2d = gmask[None, :, None] & gmask[None, None, :]
    local = (~gmask)[None, :].to(dtype)

    def tie(x):
        mean = torch.sum(x * w[:, None], dim=0) / nvalid
        x = torch.where(gmask[None, :], mean[None, :], x)
        if lower is not None:
            x = torch.maximum(x, lower)
        if upper is not None:
            x = torch.minimum(x, upper)
        return x

    def cost_grad_hess(x):
        """ONE sweep -> (joint cost, tied g, tied H)."""
        r, J = residual_jac_fn(x, *args)
        r = r * w.reshape((B,) + (1,) * (r.dim() - 1))
        J = J * w.reshape((B,) + (1,) * (J.dim() - 1))
        cost = torch.sum(r * r)  # w is 0/1, so w² = w
        g = torch.einsum("bvn,bn->bv", J, r)
        H = torch.einsum("bun,bvn->buv", J, J)
        g_shared = torch.sum(g * gmask[None, :], dim=0)
        g = torch.where(gmask[None, :], g_shared[None, :] / nvalid, g)
        H_shared = torch.sum(H * share2d, dim=0)
        H = torch.where(share2d, H_shared[None] / nvalid, H)
        return cost, g, H

    x = tie(x0)
    cost, g, H = cost_grad_hess(x)
    lam = torch.tensor(lam0, dtype=dtype, device=device)
    active = torch.tensor(True, device=device)
    converged = torch.tensor(False, device=device)
    it_lane = torch.zeros((B,), dtype=torch.int32, device=device)
    n_run = 0
    for it in range(max_iter):
        if not bool(active):
            break
        delta = damped_solve(H, g, lam.expand(B))
        x_trial = tie(x + delta)
        c_trial, g_trial, H_trial = cost_grad_hess(x_trial)
        better = c_trial < cost
        g = torch.where(better, g_trial, g)
        H = torch.where(better, H_trial, H)
        x_new = torch.where(better, x_trial, x)
        cost_new = torch.where(better, c_trial, cost)
        lam_new = torch.where(
            better, lam * lam_down, torch.clamp(lam * lam_up, max=lam_max)
        )
        conv_f = (cost - c_trial) <= ftol * torch.clamp(cost, min=1e-30)
        step = torch.abs(x_trial - x)
        conv_x = torch.amax(step) <= xtol * (xtol + torch.amax(torch.abs(x)))
        plateau = (lam_new >= 1e6 * lam0) & torch.isfinite(cost_new)
        conv_now = (better & (conv_f | conv_x)) | plateau
        done = conv_now | (lam_new >= lam_max)
        # a lane's own iteration count: the last iteration at which its
        # local slots moved past its xtol threshold, floored at ~8 ulp of
        # the lane's scale (global slots move whenever any lane pulls them)
        lane_step = torch.amax(step * local, dim=1)
        lane_xn = torch.amax(torch.abs(x) * local, dim=1)
        tol_lane = torch.maximum(xtol * (xtol + lane_xn), 1e-6 * lane_xn)
        moved = better & (lane_step > tol_lane)
        it_lane = torch.where(moved, it + 1, it_lane)
        converged = converged | conv_now
        active = active & ~done
        x, cost, lam = x_new, cost_new, lam_new
        n_run = it + 1

    # per-lane cost: the loop carries only the joint sum, which must not be
    # broadcast per lane (it would inflate every lane's rms)
    r_fin = residual_fn(x, *args)
    lane_cost = torch.sum(r_fin * r_fin, dim=tuple(range(1, r_fin.dim())))
    lane_stopped = it_lane < n_run
    return LMResult(
        x=x,
        cost=lane_cost,
        n_iter=torch.where(valid, it_lane, 0).to(torch.int32),
        converged=(converged.expand(B) | lane_stopped) & valid,
    )
