"""Plain reference of frame-to-frame linking: trackpy's objective, solved
exactly frame by frame.

In each frame, the live tracks' last positions and the frame's features
are assigned so that the total squared displacement is least, where a
pair may link only within ``search_range`` (distance <= search_range), a
feature left unlinked costs search_range² (it starts a new track) and a
track left unlinked costs nothing.  A track stays a candidate for
``memory`` frames after the last frame it was seen in: seen in frame t, it
can take a feature of frame t + memory + 1 at the latest.  New tracks take
ids in order of their feature's row.

The assignment is ``scipy.optimize.linear_sum_assignment`` on the whole
frame's [features, tracks + features] matrix (each feature's own null
column at search_range²), in float64.  trackpy solves each subnet (a
connected component of the candidate pairs) on its own; since the cost
is a sum over subnets, the whole frame's optimum is the subnets' optima
together.  Departures: equal-cost optima may break otherwise than
trackpy's, and positions are compared in float64.  This imports nothing
of the port.
"""
from __future__ import annotations

import numpy as np


def link(positions, search_range, memory=0):
    """Particle ids of the features of consecutive frames.

    ``positions``: a list with one [k_t, D] array per frame, empty frames
    included.  Returns a list of [k_t] int64 ids."""
    from scipy.optimize import linear_sum_assignment

    sr2 = float(search_range) ** 2
    last_pos = np.zeros((0, positions[0].shape[1] if positions else 2))
    last_t = np.zeros(0, np.int64)
    ids = np.zeros(0, np.int64)
    next_id = 0
    out = []
    for t, pos in enumerate(positions):
        pos = np.asarray(pos, np.float64)
        k = len(pos)
        got = np.full(k, -1, np.int64)
        live = np.flatnonzero(t - last_t <= memory + 1)
        if k and len(live):
            d2 = ((pos[:, None, :] - last_pos[None, live, :]) ** 2).sum(-1)
            big = 4.0 * sr2 * (k + len(live)) + 1.0   # never chosen
            cost = np.full((k, len(live) + k), big)
            cost[:, :len(live)] = np.where(d2 <= sr2, d2, big)
            cost[np.arange(k), len(live) + np.arange(k)] = sr2
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if c < len(live) and cost[r, c] <= sr2:
                    tr = live[c]
                    got[r] = ids[tr]
                    last_pos[tr] = pos[r]
                    last_t[tr] = t
        new = np.flatnonzero(got < 0)
        got[new] = next_id + np.arange(len(new))
        next_id += len(new)
        last_pos = np.concatenate([last_pos, pos[new]])
        last_t = np.concatenate([last_t, np.full(len(new), t, np.int64)])
        ids = np.concatenate([ids, got[new]])
        out.append(got)
    return out
