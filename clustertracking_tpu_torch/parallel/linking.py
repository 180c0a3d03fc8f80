"""Frame-sharded linking with boundary stitching.

Counterpart of ``clustertracking_tpu/parallel/linking.py``.  Linking is
the only stage of the pipeline with a sequential dependency along the
time axis (frame t links against t-1..t-memory-1).  The video splits
into S contiguous frame ranges; each range is linked on its own device
(``ops/link.py``'s auctions, no communication), then trajectories are
stitched across the S-1 cuts on the host.  The only cross-shard data is
each range's head and tail track summaries.

Semantics (the reference's): within a shard, identical to
``link_on_device`` / ``link_on_device_binned``; at a cut, a tail track
(last seen within ``memory + 1`` frames before it) continues into a head
track (first seen within ``memory + 1`` frames after it) by the same
objective as the in-shard linker — per connected subnet of candidate
(head, tail) pairs, the Hungarian minimum of Σ d², an unmatched head
costing ``search_range²``.  With short shards (``Ts <= memory``) the
tails come from the ``ceil((memory + 1) / Ts)`` trailing shards, so a
track whose absence swallows a whole shard still bridges; a tail
consumed at one cut is not matched again by a stale appearance.

The reference finds the candidate pairs with a Python loop over heads ×
tails; here a ``cKDTree`` over the tails' positions gives the same pairs
(radius ``search_range``, then the reference's float32 distance and gap
tests), and the subnets are the connected components of that graph, so a
cut between two frames of 10⁴ features takes tens of milliseconds on the
host instead of 10⁸ Python iterations.  The ids come out equal to the
reference's.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np

__all__ = ["link_sharded"]


def _heads_tails(parts_s, pos_s, valid_s, window):
    """Per-track first and last appearance inside one shard, tracks in
    order of first appearance (frame, then slot).

    Returns ``(heads, tails)``, each ``(ids, local_frames, positions)``:
    heads are the tracks first seen in the first ``window`` frames, tails
    those last seen in the final ``window`` frames."""
    Ts, K = parts_s.shape
    ids = parts_s.reshape(-1)
    slots = np.nonzero(valid_s.reshape(-1) & (ids >= 0))[0]
    pid = ids[slots]
    uniq, first = np.unique(pid, return_index=True)
    _, last_rev = np.unique(pid[::-1], return_index=True)
    last = len(pid) - 1 - last_rev
    order = np.argsort(first, kind="stable")
    uniq = uniq[order]
    first_slot, last_slot = slots[first[order]], slots[last[order]]
    pos = pos_s.reshape(Ts * K, -1)

    def pick(flat_slot, keep):
        s = flat_slot[keep]
        return uniq[keep], s // K, pos[s]

    return (pick(first_slot, first_slot // K < window),
            pick(last_slot, last_slot // K >= Ts - window))


def _in_shard(pos_s, val_s, search_range, memory, backend, bounds, devices):
    """Each shard's particle ids [S, Ts, K] (shard-local), linked by the
    auction on its own device."""
    import torch

    from ..ops.link import link_on_device, link_on_device_binned

    out = []
    for s, dev in enumerate(devices):
        p = torch.as_tensor(pos_s[s], device=dev)
        v = torch.as_tensor(val_s[s], device=dev)
        if backend == "device-binned":
            ids = link_on_device_binned(p, v, float(search_range),
                                        int(memory), bounds=bounds)
        else:
            ids = link_on_device(p, v, float(search_range), int(memory))
        out.append(ids)
    return np.stack([ids.cpu().numpy() for ids in out])


def link_sharded(
    positions,
    valid,
    search_range: float,
    memory: int = 0,
    n_shards: Optional[int] = None,
    mesh=None,
    axis: str = "data",
    backend: str = "auto",
    device=None,
):
    """Link [T, K, D] padded per-frame positions across an S-way split.

    With ``mesh`` given, shard ``s`` is linked on ``mesh.devices[s %
    mesh.size]`` and S defaults to the mesh's size; otherwise every shard
    on ``device`` (None is 'cuda', and raises ``RuntimeError`` where no
    CUDA device exists), S defaulting to 1.  Returns particle ids [T, K]
    (int64, -1 on padding), stitched and numbered 0, 1, ... in order of
    first appearance.

    ``backend``: 'device' runs the dense [K, K·(memory+2)] auction in
    every shard; 'device-binned' the spatially binned one, with cell-grid
    bounds from the real rows of the whole video quantized to 64 px;
    'auto' takes 'device' up to K = 2,048 features a frame, as the
    single-device path does.  ``link_sharded.last_stats`` keeps the last
    call's seconds in the shards' auctions (``link_s``) and in the stitch
    (``stitch_s``), and its shard count.
    """
    from scipy.optimize import linear_sum_assignment
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    positions = np.asarray(positions, np.float32)
    valid = np.asarray(valid, bool)
    T, K, D = positions.shape
    if backend == "auto":
        backend = "device" if K <= 2048 else "device-binned"
    if backend not in ("device", "device-binned"):
        raise ValueError(f"Unknown sharded link backend {backend!r}")
    if mesh is not None and axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis_names}")
    if n_shards is None:
        n_shards = mesh.size if mesh is not None else 1
    S = int(n_shards)
    if mesh is not None:
        devices = [mesh.devices[s % mesh.size] for s in range(S)]
    else:
        from ..utils.device import _resolve_device

        devices = [_resolve_device(device, "link_sharded")] * S
    Ts = -(-T // S)
    Tpad = S * Ts
    if Tpad > T:
        positions = np.concatenate(
            [positions, np.full((Tpad - T, K, D), 1e8, np.float32)]
        )
        valid = np.concatenate([valid, np.zeros((Tpad - T, K), bool)])
    pos_s = positions.reshape(S, Ts, K, D)
    val_s = valid.reshape(S, Ts, K)

    bounds = None
    if backend == "device-binned":
        # global cell-grid bounds from the REAL rows (pads sit at 1e8),
        # quantized to 64 px, the same for every shard
        if valid.any():
            real = positions.reshape(-1, D)[valid.reshape(-1)]
        else:
            real = np.zeros((1, D), np.float32)
        bounds = tuple(
            (
                float(np.floor(real[:, d].min() / 64.0) * 64.0),
                float(np.ceil((real[:, d].max() + 1) / 64.0) * 64.0),
            )
            for d in range(D)
        )
    t0 = time.perf_counter()
    parts = _in_shard(pos_s, val_s, search_range, memory, backend, bounds,
                      devices)
    t1 = time.perf_counter()

    # globalize ids: shard-local ids are < Ts*K
    offset = Ts * K
    parts = parts.astype(np.int64)
    parts = np.where(
        parts >= 0, parts + np.arange(S)[:, None, None] * offset, -1
    )

    # stitch the cuts left -> right
    window = memory + 1
    # a tail further back than ``reach`` shards is more than ``window``
    # frames from any head
    reach = max(1, -(-window // Ts))
    remap: dict = {}
    # root id -> global frame at which that track's tail was last consumed
    # by a stitch: an appearance as old or older must not match again at a
    # later cut, while a newer one (the continuation itself) may
    consumed: dict = {}
    sr2 = float(search_range) ** 2
    # the tree's radius: never below the float32 test's (which rounds)
    r_tree = float(search_range) * (1.0 + 1e-5) + 1e-6

    def resolve(pid):
        while pid in remap:
            pid = remap[pid]
        return pid

    heads_tails = [_heads_tails(parts[s], pos_s[s], val_s[s], window)
                   for s in range(S)]
    for s in range(1, S):
        h_ids, h_t, h_pos = heads_tails[s][0]
        if not len(h_ids):
            continue
        # latest appearance per physical track (resolved id) across the
        # reachable trailing shards, in global frames
        tails_all: dict = {}  # root -> (global frame, position)
        for j in range(1, min(reach, s) + 1):
            t_ids, t_t, t_pos = heads_tails[s - j][1]
            for tid, tf, p in zip(t_ids.tolist(), t_t.tolist(), t_pos):
                root = resolve(tid)
                gf_t = (s - j) * Ts + tf
                if root in consumed and gf_t <= consumed[root]:
                    continue
                if root not in tails_all or gf_t > tails_all[root][0]:
                    tails_all[root] = (gf_t, p)
        if not tails_all:
            continue
        roots = sorted(tails_all)          # ascending: each subnet's ts
        tail_gf = np.array([tails_all[r][0] for r in roots])
        tail_pos = np.stack([tails_all[r][1] for r in roots])
        # candidate (head, tail) pairs, heads in order of first appearance:
        # within search_range and at most ``window`` frames apart, the
        # distance in float32 as the reference computes it
        near = cKDTree(tail_pos).query_ball_point(h_pos, r=r_tree)
        hi = np.repeat(np.arange(len(h_ids)), [len(n) for n in near])
        ti = np.fromiter(itertools.chain.from_iterable(near), np.int64,
                         len(hi))
        diff = h_pos[hi] - tail_pos[ti]
        d2 = np.sum(diff * diff, axis=1).astype(np.float64)
        keep = (s * Ts + h_t[hi] - tail_gf[ti] <= window) & (d2 <= sr2)
        hi, ti, d2 = hi[keep], ti[keep], d2[keep]
        if not len(hi):
            continue
        # subnets: connected components of the bipartite candidate graph
        nh = len(h_ids)
        graph = coo_matrix((np.ones(len(hi)), (hi, nh + ti)),
                           shape=(nh + len(roots),) * 2)
        n_sub, label = connected_components(graph, directed=False)
        edge_sub = label[hi]
        # a subnet of one head and one tail closer than search_range
        # matches them (the Hungarian's only choice); the others solve the
        # in-shard objective: min Σ d², an unmatched head costing
        # search_range²
        alone = np.bincount(edge_sub, minlength=n_sub)[edge_sub] == 1
        pairs = list(zip(hi[alone & (d2 < sr2)].tolist(),
                         ti[alone & (d2 < sr2)].tolist()))
        rest = np.flatnonzero(~(alone & (d2 < sr2)))
        rest = rest[np.argsort(edge_sub[rest], kind="stable")]
        cuts = np.flatnonzero(np.diff(edge_sub[rest])) + 1
        for e in np.split(rest, cuts) if len(rest) else ():
            hs = np.unique(hi[e])
            ts = np.unique(ti[e])
            F, Tn = len(hs), len(ts)
            cost = np.full((F, Tn + F), 4.0 * sr2)
            cost[np.arange(F), Tn + np.arange(F)] = sr2
            cost[np.searchsorted(hs, hi[e]), np.searchsorted(ts, ti[e])] = \
                d2[e]
            rows, cols = linear_sum_assignment(cost)
            pairs += [(int(hs[r]), int(ts[c])) for r, c in zip(rows, cols)
                      if c < Tn and cost[r, c] <= sr2]
        for h, t in pairs:
            root = resolve(roots[t])
            remap[int(h_ids[h])] = root
            consumed[root] = int(tail_gf[t])

    flat = parts.reshape(Tpad, K)[:T].reshape(-1)
    real = flat >= 0
    if remap:
        uniq = np.unique(flat[real])
        lut = np.array([resolve(int(u)) for u in uniq], np.int64)
        flat = np.where(real, lut[np.searchsorted(uniq, flat)], -1)
    # canonicalize to consecutive ids in order of first appearance
    uniq, first, inv = np.unique(flat[real], return_index=True,
                                 return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    out = np.full(flat.shape, -1, np.int64)
    out[real] = rank[inv.reshape(-1)]
    link_sharded.last_stats = dict(shards=S, link_s=t1 - t0,
                                   stitch_s=time.perf_counter() - t1)
    return out.reshape(T, K)


link_sharded.last_stats = None
