"""The numbers by which a fit is held to the plain reference.

Each is a gap between two fits of the same lanes: the program's (or the
control's) and the reference's.  The per-lane tolerance, 1e-3 px and
1e-3 of the rms, is the one the port's kernels are held to against their
plain versions (chip_smoke.py).  Only the lanes both fitted count for the
position and cost gaps; the share of lanes whose decisions differ
(converged, accepted) is a number of its own.
"""
from __future__ import annotations

import numpy as np


def lane_gaps(pos_a, rms_a, conv_a, pos_r, rms_r, conv_r, valid):
    """Gaps of one bucket's lanes.  ``pos_*`` [B, n, D], ``rms_*`` [B],
    ``conv_*`` [B] as numpy; ``valid`` [B] bool.  Returns per-lane arrays:
    the largest position gap (px), the relative rms gap, and whether the
    converged flags differ."""
    pos_gap = np.abs(pos_a - pos_r).reshape(len(pos_a), -1).max(axis=1)
    rms_gap = np.abs(rms_a - rms_r) / np.maximum(np.abs(rms_r), 1e-30)
    conv_differ = conv_a != conv_r
    keep = valid
    return pos_gap[keep], rms_gap[keep], conv_differ[keep]


def summary(pos_gap, rms_gap, conv_differ, tol_px=1e-3, tol_rms=1e-3):
    """The numbers compared, and their tails for the record.

    ``lanes_off`` is the share of lanes outside the per-lane tolerance
    (a position gap over ``tol_px`` or a relative rms gap over
    ``tol_rms``, or either not finite): the widest gap over some 10^5
    lanes swings from run to run with the odd lane whose refit path a
    last bit decides, the share of such lanes does not."""
    pos_gap = np.asarray(pos_gap, float)
    rms_gap = np.asarray(rms_gap, float)
    fin = np.isfinite(pos_gap) & np.isfinite(rms_gap)
    off = ~fin | (pos_gap > tol_px) | (rms_gap > tol_rms)

    def q(a, p):
        return float(np.quantile(a, p)) if len(a) else float("nan")

    return {
        "pos_gap_px": float(pos_gap.max()) if fin.all() else float("inf"),
        "pos_gap_p999_px": q(pos_gap[fin], 0.999),
        "pos_gap_median_px": q(pos_gap[fin], 0.5),
        "rms_gap_rel": float(rms_gap.max()) if fin.all() else float("inf"),
        "rms_gap_p999_rel": q(rms_gap[fin], 0.999),
        "rms_gap_median_rel": q(rms_gap[fin], 0.5),
        "converged_differ": float(np.mean(conv_differ))
        if len(conv_differ) else 0.0,
        "lanes_off": float(np.mean(off)) if len(off) else 0.0,
        "lanes": int(len(pos_gap)),
    }
