"""Operations and bytes a Levenberg–Marquardt fit of clusters has to do,
and the least time an H100 could take for them.

The FP32 operations per in-mask pixel of one Jacobian sweep are a frozen
copy of ``chip_smoke.py::_pixel_ops`` and its tables, counted from the
port's LM core (``csrc/lm_core.cuh``: expf, sqrtf and a division count one
each): each feature's model value and Jacobian row, then the cost, g and
upper-H sums, a product and an add each.  A damped Cholesky solve of V
slots counts V³/3 + 2V².  The work of a fit is fixed by its inputs: the
lanes each refit round solves, their in-mask pixels, and the iterations
that the benchmark's own reference takes on the same inputs; never the
program's own iteration counts.
"""
from __future__ import annotations

import json
from pathlib import Path

# profile tags of lm_core.cuh: gauss, ring, hat, disc (inv_series apart)
PROFILE_OPS = {0: 3, 1: 13, 2: 15, 3: 12}
DEXTRA_OPS = {1: 10, 2: 17}
# a pose's chain rule per feature: fixed distance, and what a fitted one
# adds (pose kinds: none, 2D n-gon, 3D axis, 3D rotation)
POSE_OPS = {0: (0, 0), 1: (7, 5), 2: (13, 7), 3: (24, 7)}

PEAKS = json.loads((Path(__file__).resolve().parent / "h100.json")
                   .read_text())


def pixel_ops(n, D, V, iso, prof=0, nx=0, pose=0, fit_dist=0):
    """FP32 operations per in-mask pixel of one sweep."""
    feat = 4 * D + 6 + 5 * D + (5 if iso else 5 * D)
    if prof == 4:   # inv_series: nx coefficients
        feat += 7 * nx + 4 + sum(k + 7 for k in range(nx))
    else:
        feat += PROFILE_OPS[prof] + DEXTRA_OPS.get(prof, 0)
    fixed, dist = POSE_OPS[pose]
    feat += fixed + dist * fit_dist
    return n * feat + 4 + 2 * (1 + V + V * (V + 1) // 2)


def solve_ops(V):
    """FP32 operations of one damped Cholesky solve of V slots."""
    return V ** 3 / 3 + 2 * V * V


def lane_bytes(n, P, D, V):
    """Bytes a lane of a solve reads and writes besides its window: start
    vector, constants, frame index, positions, origin, norm and need in;
    solution, cost, iterations, flag and pixel count out."""
    return 4 * (2 * V + n * P + n * D + D + 5) + 2


def fit_work(rounds, *, n, D, V, window_pixels, lane_bytes, iso=True,
             prof=0):
    """(ops, bytes) of the refit rounds of one bucket solve.

    ``rounds``: per round, numpy arrays ``need`` [B] (lanes solved),
    ``n_iter`` [B] and ``npix`` [B] from the reference.  A solved lane
    sweeps its in-mask pixels n_iter + 1 times and solves n_iter times;
    it reads its window once and its inputs and writes its outputs
    (``lane_bytes``) once a round."""
    per_pixel = pixel_ops(n, D, V, iso, prof)
    ops = 0.0
    nbytes = 0.0
    for r in rounds:
        need = r["need"] & (r["npix"] > 0)
        it = r["n_iter"][need].astype(float)
        npix = r["npix"][need].astype(float)
        ops += per_pixel * float((npix * (it + 1)).sum()) \
            + solve_ops(V) * float(it.sum())
        nbytes += float(need.sum()) * (4 * window_pixels + lane_bytes)
    return ops, nbytes


def least_seconds(ops, nbytes):
    """The least time the card could take: the larger of the operations
    at the FP32 peak and the bytes at the memory rate."""
    return max(ops / PEAKS["fp32_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])
