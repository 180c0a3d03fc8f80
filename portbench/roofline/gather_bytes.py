"""Bytes a window gather has to move, and so the least time an H100 could
take for it (``lm_ops.least_seconds`` with no operations).

A gather reads each window that a solve needs from the stacks and writes
it out once, and reads the window's origin (D int32) and its stack index
(one int32).  The windows a fit needs are those of the lanes that the
benchmark's own reference solves in each refit round, on the same inputs:
never the program's own counts, and not the lanes a gather copies without
a solve needing them.
"""
from __future__ import annotations


def window_bytes(lanes, *, D, window_pixels):
    """Bytes of gathering ``lanes`` float32 windows of ``window_pixels``
    each: one read and one write of each voxel, the origin and the stack
    index."""
    return float(lanes) * (2 * 4 * window_pixels + 4 * D + 4)


def fit_bytes(rounds, *, D, window_pixels):
    """Bytes of the gathers of one bucket solve: ``rounds`` as
    ``lm_ops.fit_work`` takes them (per round, numpy ``need`` [B])."""
    return sum(window_bytes(int(r["need"].sum()), D=D,
                            window_pixels=window_pixels) for r in rounds)
