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

from .collectives import all_reduce

__all__ = ["GlobalShard", "LMResult", "damped_solve", "lm_solve",
           "lm_solve_global", "lm_solve_global_shards"]


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

    The body is ``lm_solve_global_shards`` on one shard.
    """
    shard = GlobalShard(residual_fn, residual_jac_fn, x0, args, lower, upper,
                        valid)
    return lm_solve_global_shards(
        [shard], global_slots, max_iter=max_iter, ftol=ftol, xtol=xtol,
        lam0=lam0, lam_up=lam_up, lam_down=lam_down, lam_max=lam_max)[0]


class GlobalShard(NamedTuple):
    """One shard's lanes of a tied solve: its residual functions, x0
    [B_s, V], args, bounds ([V] or [B_s, V], or None) and valid [B_s]
    (None: all), on the shard's device."""
    residual_fn: Callable
    residual_jac_fn: Callable
    x0: torch.Tensor
    args: Tuple = ()
    lower: Optional[torch.Tensor] = None
    upper: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None


def lm_solve_global_shards(
    shards,
    global_slots,
    *,
    max_iter: int = 50,
    ftol: float = 1.49e-8,
    xtol: float = 1.49e-8,
    lam0: float = 1e-3,
    lam_up: float = 4.0,
    lam_down: float = 0.25,
    lam_max: float = 1e10,
) -> list:
    """``lm_solve_global`` over lanes split into shards (``GlobalShard``),
    each on its own device: one joint solve, a list of per-shard
    ``LMResult``.

    Every sum over lanes is a per-shard partial sum passed through
    ``all_reduce`` (``ops/collectives.py``: summed in shard order, the
    total sent back to every shard): the tie's weighted mean and
    ``nvalid``; the joint cost, ``g_shared`` and ``H_shared`` (one call
    per sweep); the step and |x| maxima of the xtol test (``op='max'``).
    Every shard then takes the same joint decisions from the same values.
    Per-lane work (residuals, Jacobians, the damped solves) stays on each
    shard's device.  On one shard ``all_reduce`` returns its input, so the
    arithmetic is that of a solve on one device."""
    S = range(len(shards))
    xs0 = [sh.x0 for sh in shards]
    dtype = xs0[0].dtype
    Bs = [x.shape[0] for x in xs0]
    V = xs0[0].shape[1]
    devs = [x.device for x in xs0]
    gmask = [torch.as_tensor(list(map(bool, global_slots)), dtype=torch.bool,
                             device=d) for d in devs]
    valid = [torch.ones((B,), dtype=torch.bool, device=d)
             if sh.valid is None else sh.valid
             for sh, B, d in zip(shards, Bs, devs)]
    w = [v.to(dtype) for v in valid]
    nvalid = [torch.clamp(n, min=1.0)
              for n in all_reduce([torch.sum(ws) for ws in w])]
    share2d = [g[None, :, None] & g[None, None, :] for g in gmask]
    local = [(~g)[None, :].to(dtype) for g in gmask]

    def tie(xs):
        means = all_reduce([torch.sum(xs[s] * w[s][:, None], dim=0) for s in S])
        out = []
        for s in S:
            x = torch.where(gmask[s][None, :], (means[s] / nvalid[s])[None, :],
                            xs[s])
            if shards[s].lower is not None:
                x = torch.maximum(x, shards[s].lower)
            if shards[s].upper is not None:
                x = torch.minimum(x, shards[s].upper)
            out.append(x)
        return out

    def cost_grad_hess(xs):
        """ONE sweep of every shard -> (joint cost, tied g, tied H) per
        shard, the cost and the shared blocks all-reduced in one call."""
        gs, Hs, parts = [], [], []
        for s in S:
            B = Bs[s]
            r, J = shards[s].residual_jac_fn(xs[s], *shards[s].args)
            r = r * w[s].reshape((B,) + (1,) * (r.dim() - 1))
            J = J * w[s].reshape((B,) + (1,) * (J.dim() - 1))
            g = torch.einsum("bvn,bn->bv", J, r)
            H = torch.einsum("bun,bvn->buv", J, J)
            parts.append(torch.cat([
                torch.sum(r * r).reshape(1),  # w is 0/1, so w² = w
                torch.sum(g * gmask[s][None, :], dim=0),
                torch.sum(H * share2d[s], dim=0).reshape(-1)]))
            gs.append(g)
            Hs.append(H)
        tot = all_reduce(parts)
        costs = []
        for s in S:
            cost, g_shared, H_shared = torch.split(tot[s], [1, V, V * V])
            gs[s] = torch.where(gmask[s][None, :], g_shared[None, :]
                                / nvalid[s], gs[s])
            Hs[s] = torch.where(share2d[s], H_shared.reshape(V, V)[None]
                                / nvalid[s], Hs[s])
            costs.append(cost[0])
        return costs, gs, Hs

    x = tie(xs0)
    cost, g, H = cost_grad_hess(x)
    lam = [torch.tensor(lam0, dtype=dtype, device=d) for d in devs]
    active = [torch.tensor(True, device=d) for d in devs]
    converged = [torch.tensor(False, device=d) for d in devs]
    it_lane = [torch.zeros((B,), dtype=torch.int32, device=d)
               for B, d in zip(Bs, devs)]
    n_run = 0
    for it in range(max_iter):
        if not bool(active[0]):
            break
        x_trial = tie([x[s] + damped_solve(H[s], g[s], lam[s].expand(Bs[s]))
                       for s in S])
        c_trial, g_trial, H_trial = cost_grad_hess(x_trial)
        step = [torch.abs(x_trial[s] - x[s]) for s in S]
        # the xtol test's maxima over every lane of every shard
        mx = all_reduce([torch.stack([torch.amax(step[s]),
                                      torch.amax(torch.abs(x[s]))])
                         for s in S], op="max")
        for s in S:
            better = c_trial[s] < cost[s]
            g[s] = torch.where(better, g_trial[s], g[s])
            H[s] = torch.where(better, H_trial[s], H[s])
            x_new = torch.where(better, x_trial[s], x[s])
            cost_new = torch.where(better, c_trial[s], cost[s])
            lam_new = torch.where(
                better, lam[s] * lam_down,
                torch.clamp(lam[s] * lam_up, max=lam_max)
            )
            conv_f = (cost[s] - c_trial[s]) <= ftol * torch.clamp(
                cost[s], min=1e-30)
            conv_x = mx[s][0] <= xtol * (xtol + mx[s][1])
            plateau = (lam_new >= 1e6 * lam0) & torch.isfinite(cost_new)
            conv_now = (better & (conv_f | conv_x)) | plateau
            done = conv_now | (lam_new >= lam_max)
            # a lane's own iteration count: the last iteration at which its
            # local slots moved past its xtol threshold, floored at ~8 ulp
            # of the lane's scale (global slots move whenever any lane
            # pulls them)
            lane_step = torch.amax(step[s] * local[s], dim=1)
            lane_xn = torch.amax(torch.abs(x[s]) * local[s], dim=1)
            tol_lane = torch.maximum(xtol * (xtol + lane_xn),
                                     1e-6 * lane_xn)
            moved = better & (lane_step > tol_lane)
            it_lane[s] = torch.where(moved, it + 1, it_lane[s])
            converged[s] = converged[s] | conv_now
            active[s] = active[s] & ~done
            x[s], cost[s], lam[s] = x_new, cost_new, lam_new
        n_run = it + 1

    # per-lane cost: the loop carries only the joint sum, which must not be
    # broadcast per lane (it would inflate every lane's rms)
    out = []
    for s in S:
        r_fin = shards[s].residual_fn(x[s], *shards[s].args)
        lane_cost = torch.sum(r_fin * r_fin,
                              dim=tuple(range(1, r_fin.dim())))
        lane_stopped = it_lane[s] < n_run
        out.append(LMResult(
            x=x[s],
            cost=lane_cost,
            n_iter=torch.where(valid[s], it_lane[s], 0).to(torch.int32),
            converged=(converged[s].expand(Bs[s]) | lane_stopped)
            & valid[s],
        ))
    return out
