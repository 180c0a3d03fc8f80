"""Frame-to-frame linking on the device: the auction linkers.

Counterpart of ``clustertracking_tpu/ops/link.py``.  The reference runs
them as XLA (a ``lax.scan`` over frames with a ``lax.while_loop`` auction
inside).  Here the dense auction has two routes, chosen by the device of
its input (``auction_route``):

- 'kernel': on CUDA, whatever K, memory and D.  One launch of
  ``csrc/link_auction.cu`` runs every frame's costs, auction rounds and
  track update in one block, and no frame needs the host: each frame's
  rounds come back in one copy of T integers at the end.  The track state
  sits in the block's shared memory where it fits (config 2: ~29 KB),
  else in a global workspace (``last_stats['state']``); the library
  decides, from the device's limit and the kernel's own static bytes.
- 'torch' (``_link_torch``): on every other device (the CPU).  A Python
  loop walks the frames with the state tensors on the positions' device,
  and each auction round is a handful of torch ops.

The binned auction (``link_on_device_binned``) always runs the torch loop.

- Features per frame are padded to a static K; tracks live in a ring
  buffer of M = K·(memory+2) slots (new tracks overwrite the oldest slots,
  sized so an active track is never evicted early).
- Matching per frame is a parallel AUCTION: unassigned features bid for
  their cheapest track at a price increment of (second-best − best) + ε,
  every track accepts its highest bidder (ties: the lowest feature index),
  outbid features return to the pool, and a feature whose best effective
  cost exceeds ``search_range²`` takes the null option (a new track) — the
  objective the host linker solves exactly per subnet (min Σd², an
  unlinked feature costs search_range²), ε-optimal with
  ε = 1e-5·SR² + 1e-12.  Unresolved at ``auction_rounds`` goes null.
- ``memory``: a track unseen for ≤ memory frames can still claim a
  feature.

Positions, prices and costs are float32, as in the reference: the auction
compares prices that accumulate in float32, and float64 would decide
other ties.  The kernel performs the torch loop's float32 operations in
the same order, so both routes give the same particles bit for bit.  The
torch loop writes the reference's ``.at[i].set(..., mode="drop")`` with an
out-of-range sentinel into one extra dump slot, so that no round needs
the host; the host sees the state once every few rounds (``_check_points``)
to stop the auction.  The kernel reads whether any feature is unresolved
after every round, on the device.  A round after every feature is resolved
changes nothing (every bid is −BIG, no track is won), so either way the
result is the reference's as long as the rounds stop at
``auction_rounds`` in all.  Each linker keeps the last call's
``last_stats``: frames; ``rounds``, per frame the rounds run (the torch
loop's rounded up to its next check point, the kernel's exact); ``syncs``,
per frame the host reads (the check points reached; 0 on the kernel
route); and, for ``link_on_device``, the ``route`` taken.
``link_on_device.launches_kernel`` counts the kernel's launches.

Output: particle id per (frame, feature slot), int32, -1 on padding.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["link_on_device", "link_on_device_binned", "auction_route"]

_BIG = float(np.float32(1e30))
_HALF_BIG = float(np.float32(1e30) / np.float32(2.0))


def _check_points(cap):
    """The auction rounds after which the host reads whether any feature
    is still unresolved: 1, 2, 4, 8, 16, 24, 32, 48, 64, then every 16,
    up to ``cap`` (at most 8 syncs a frame at the default cap of 64)."""
    pts = [1, 2, 4, 8, 16, 24, 32, 48, 64]
    while pts[-1] < cap:
        pts.append(pts[-1] + 16)
    return [min(c, cap) for c in pts]


def _r2_eps(search_range):
    """search_range² and ε in float32, as the reference computes them."""
    r2max = np.float32(search_range) ** 2
    eps = r2max * np.float32(1e-5) + np.float32(1e-12)
    return float(r2max), float(eps)


def _sq_dist(a, b):
    """Σ_d (a_d − b_d)², summed over the last axis in axis order (XLA's
    reduction order for jnp.sum over a short axis)."""
    diff = a[..., 0] - b[..., 0]
    d2 = diff * diff
    for d in range(1, a.shape[-1]):
        diff = a[..., d] - b[..., d]
        d2 = d2 + diff * diff
    return d2


def _auction(d2, ok, r2max, eps, M, auction_rounds, cand=None):
    """One frame's auction on the cost matrix ``d2`` [K, Q] (BIG where
    infeasible).  ``cand`` [K, Q] names each column's track (the binned
    linker's candidate graph; None: column q is track q).  Returns
    (feat_track [K]: the track won, -1 unresolved or -2 null; rounds run;
    host syncs)."""
    K = d2.shape[0]
    dev = d2.device
    ar_k = torch.arange(K, device=dev)
    ar_m = torch.arange(M, device=dev)
    if cand is not None:
        safe_cand = torch.clamp(cand, max=M - 1)
    has_cand = (d2 < _BIG).any(dim=1)
    # feat_track carries one dump slot (index K) for the reference's
    # dropped out-of-range writes
    ft = torch.full((K + 1,), -2, dtype=torch.int64, device=dev)
    ft[:K] = torch.where(ok & has_cand, -1, -2)
    p = torch.zeros(M, dtype=torch.float32, device=dev)
    owner = torch.full((M,), -1, dtype=torch.int64, device=dev)
    big = torch.full((), _BIG, dtype=torch.float32, device=dev)
    rounds = syncs = 0
    for check in _check_points(auction_rounds):
        while rounds < check:
            active = ft[:K] == -1
            pv = p[None, :] if cand is None else p[safe_cand]
            v = torch.where(active[:, None], d2 + pv, big)
            # first index of the minimum, as jnp.argmin; the second-best
            # value is the minimum with that one entry removed
            b1 = torch.argmin(v, dim=1)
            two = torch.topk(v, 2, dim=1, largest=False, sorted=True).values
            v1, v2 = two[:, 0], two[:, 1]
            v2n = torch.clamp(v2, max=r2max)  # null is always an option
            # null strictly better than any track → a new track; prices
            # only rise, so this is final
            go_null = active & (v1 > r2max)
            ft[:K] = torch.where(go_null, -2, ft[:K])
            bidding = active & ~go_null & (v1 < _BIG)
            bid_amt = torch.where(bidding, (v2n - v1) + eps, -big)
            tgt = b1 if cand is None else cand.gather(1, b1[:, None])[:, 0]
            tgt = torch.where(bidding, tgt, M)
            # per-track highest bid, and the lowest feature index that
            # bids it (jnp.argmax's first maximum)
            maxbid = torch.full((M + 1,), -_BIG, dtype=torch.float32,
                                device=dev)
            maxbid.scatter_reduce_(0, tgt, bid_amt, "amax", include_self=True)
            maxbid = maxbid[:M]
            hit = bidding & (bid_amt >= maxbid[torch.clamp(tgt, max=M - 1)])
            winner = torch.full((M + 1,), K, dtype=torch.int64, device=dev)
            winner.scatter_reduce_(0, tgt, torch.where(hit, ar_k, K), "amin",
                                   include_self=True)
            winner = winner[:M]
            won = (maxbid > -_HALF_BIG) & (winner < K)
            # outbid previous owners return to the pool; each feature owns
            # at most one track, so these indices are unique but for the
            # dump slot K
            prev = torch.where(won & (owner >= 0), owner, K)
            ft.index_put_((prev,), torch.full_like(prev, -1))
            owner = torch.where(won, winner, owner)
            p = torch.where(won, p + maxbid, p)
            # winners take their track; each feature bids on one track, so
            # each wins at most one: unique indices but for the dump slot
            ft.index_put_((torch.where(won, winner, K),),
                          torch.where(won, ar_m, -1))
            rounds += 1
        if rounds >= auction_rounds:
            break
        syncs += 1
        if not bool((ft[:K] == -1).any()):
            break
    return ft[:K], rounds, syncs


class _Tracks:
    """The ring buffer of M track slots (+1 dump slot): positions, age in
    frames since last seen, particle id; the write pointer and the next
    id stay on the device."""

    def __init__(self, M, D, memory, device):
        self.M = M
        self.pos = torch.full((M + 1, D), 1e9, dtype=torch.float32,
                              device=device)               # far away
        self.age = torch.full((M + 1,), memory + 2, dtype=torch.int64,
                              device=device)               # dead
        self.tid = torch.zeros(M + 1, dtype=torch.int64, device=device)
        self.ptr = torch.zeros((), dtype=torch.int64, device=device)
        self.next_id = torch.zeros((), dtype=torch.int64, device=device)

    def advance(self, ft, pos, ok):
        """Apply one frame's assignment; returns its particle ids [K]."""
        M = self.M
        matched = ft >= 0
        safe_track = torch.where(matched, ft, 0)
        upd = torch.where(matched, ft, M)
        self.pos[upd] = pos
        self.age[upd] = -1                       # ages +1 below
        # new tracks for unmatched valid features → ring-buffer slots
        new = ok & ~matched
        rank = torch.cumsum(new.to(torch.int64), 0) - 1
        slot = torch.where(new, (self.ptr + rank) % M, M)
        ids_new = self.next_id + rank
        self.pos[slot] = pos
        self.age[slot] = -1
        self.tid[slot] = torch.where(new, ids_new, 0)
        n_new = new.sum()
        # read after the new tracks' ids are written, as the reference
        particle = torch.where(matched, self.tid[safe_track],
                               torch.where(new, ids_new, -1))
        self.age += 1
        self.ptr = (self.ptr + n_new) % M
        self.next_id = self.next_id + n_new
        return particle.to(torch.int32)


def auction_route(device_type):
    """The dense auction's route on a device of ``device_type``: 'kernel'
    on CUDA, whatever the shape, else 'torch'."""
    return "kernel" if device_type == "cuda" else "torch"


def link_on_device(positions, valid, search_range: float, memory: int = 0,
                   auction_rounds: int = 64):
    """positions [T, K, D] f32, valid [T, K] bool → particle [T, K] int32,
    on the positions' device: the auction on the dense [K, M] costs.

    The route is ``auction_route``'s: on CUDA one launch of
    ``csrc/link_auction.cu`` (counted in ``launches_kernel``) links the
    whole video, checking after every round on the device whether any
    feature is unresolved, and reads the rounds back once at the end
    (``last_stats['syncs']`` is 0 a frame, ``rounds`` the rounds each
    frame ran, ``state`` 'shared' or 'global' where the track state
    lived); elsewhere ``_link_torch``'s frame loop, whose ``rounds`` stop
    at the first check point with nothing unresolved and whose ``syncs``
    count the check points read.  Both give the same particles."""
    positions = positions.to(torch.float32)
    if auction_route(positions.device.type) == "kernel":
        return _link_kernel(positions, valid, search_range, memory,
                            auction_rounds)
    return _link_torch(positions, valid, search_range, memory,
                       auction_rounds)


def _link_torch(positions, valid, search_range, memory=0,
                auction_rounds=64):
    """The dense auction as a Python loop over frames, each auction round
    a handful of torch ops on the positions' device."""
    T, K, D = positions.shape
    M = K * (memory + 2)
    r2max, eps = _r2_eps(search_range)
    tracks = _Tracks(M, D, memory, positions.device)
    out, rounds, syncs = [], [], []
    for t in range(T):
        pos, ok = positions[t], valid[t]
        alive = tracks.age[:M] <= memory
        d2 = _sq_dist(pos[:, None, :], tracks.pos[None, :M, :])
        d2 = torch.where(ok[:, None] & alive[None, :], d2, _BIG)
        d2 = torch.where(d2 <= r2max, d2, _BIG)
        ft, r, s = _auction(d2, ok, r2max, eps, M, auction_rounds)
        out.append(tracks.advance(ft, pos, ok))
        rounds.append(r)
        syncs.append(s)
    link_on_device.last_stats = dict(frames=T, rounds=rounds, syncs=syncs,
                                     route="torch")
    return torch.stack(out) if out else torch.zeros(
        (0, K), dtype=torch.int32, device=positions.device)


_ARGTYPES = (
    [ctypes.c_void_p] * 2               # positions, valid
    + [ctypes.c_int] * 4                # T, K, D, memory
    + [ctypes.c_float] * 2              # r2max, eps
    + [ctypes.c_int]                    # auction_rounds
    + [ctypes.c_void_p] * 4             # particle, rounds, workspace, stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("link_auction")
    if lib.link_auction_launch.argtypes is None:
        lib.link_auction_launch.argtypes = _ARGTYPES
        lib.link_auction_launch.restype = ctypes.c_int
        lib.link_auction_workspace_bytes.argtypes = [ctypes.c_int] * 3
        lib.link_auction_workspace_bytes.restype = ctypes.c_longlong
    return lib


def _link_kernel(positions, valid, search_range, memory, auction_rounds):
    """The dense auction of the whole video in one launch of
    ``csrc/link_auction.cu`` on the positions' CUDA device."""
    T, K, D = positions.shape
    dev = positions.device
    r2max, eps = _r2_eps(search_range)
    if tuple(valid.shape) != (T, K) or memory < 0 or (T and not K):
        raise ValueError(f"link_on_device: valid {tuple(valid.shape)} for "
                         f"positions {(T, K, D)}, memory {memory}")
    positions = positions.contiguous()
    valid = valid.to(device=dev, dtype=torch.bool).contiguous()
    # the particles, then each frame's rounds
    buf = torch.empty(T * K + T, dtype=torch.int32, device=dev)
    rounds, state = [], None
    if T:
        lib = _library()
        with torch.cuda.device(dev):
            nbytes = lib.link_auction_workspace_bytes(K, D, int(memory))
            if nbytes < 0:
                raise RuntimeError(f"link_auction: no state layout for K "
                                   f"{K}, D {D}, memory {memory}")
            ws = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
                  if nbytes else None)
            rc = lib.link_auction_launch(
                positions.data_ptr(), valid.data_ptr(), T, K, D,
                int(memory), r2max, eps, int(auction_rounds),
                buf.data_ptr(), buf[T * K:].data_ptr(),
                None if ws is None else ws.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"link_auction: kernel launch failed, "
                               f"cudaError {rc}")
        link_on_device.launches_kernel += 1
        rounds = buf[T * K:].cpu().tolist()
        state = "shared" if ws is None else "global"
    link_on_device.last_stats = dict(frames=T, rounds=rounds, syncs=[0] * T,
                                     route="kernel", state=state)
    return buf[:T * K].view(T, K)


link_on_device.last_stats = None
link_on_device.launches_kernel = 0


def _neighbour_offsets(D):
    """The 3^D neighbour-cell offsets [NB, D], in meshgrid 'ij' order."""
    return np.stack(
        [g.ravel() for g in np.meshgrid(*[np.array([-1, 0, 1])] * D,
                                        indexing="ij")],
        axis=-1,
    )


def link_on_device_binned(positions, valid, search_range: float,
                          memory: int = 0, bounds: tuple = None,
                          cell_cap: int = 16, auction_rounds: int = 64):
    """The auction on a spatially binned candidate graph, for dense frames.

    Tracks are binned into cells of side ``search_range`` over ``bounds``
    (``((lo_0, hi_0), ..., (lo_{D-1}, hi_{D-1}))``, computed by the caller
    from the data); each feature bids only on the tracks in its 3^D
    neighbouring cells, at most ``cell_cap`` per cell, so a frame costs
    [K, 3^D·cell_cap] instead of [K, M].  Any track within
    ``search_range`` of a feature lies in that neighbourhood; only a cell
    holding more than ``cell_cap`` live tracks could hide one.  positions
    [T, K, D] f32, valid [T, K] bool → particle [T, K] int32."""
    positions = positions.to(torch.float32)
    T, K, D = positions.shape
    dev = positions.device
    M = K * (memory + 2)
    r2max, eps = _r2_eps(search_range)
    # divisions by a device tensor, never a Python number: CUDA multiplies
    # by the reciprocal of a host scalar, which rounds differently
    cell = torch.full((), float(search_range), dtype=torch.float32,
                      device=dev)
    lo = torch.tensor([b[0] for b in bounds], dtype=torch.float32, device=dev)
    ncell = [max(1, int((b[1] - b[0]) // float(search_range)) + 1)
             for b in bounds]
    C = int(np.prod(ncell))
    nc = torch.tensor(ncell, dtype=torch.int64, device=dev)
    offs = torch.as_tensor(_neighbour_offsets(D), dtype=torch.int64,
                           device=dev)
    ar_c = torch.arange(C, device=dev)
    j_idx = torch.arange(cell_cap, device=dev)[None, :]

    def flat_cell(ix, inb):
        ixc = torch.minimum(torch.clamp(ix, min=0), nc - 1)
        flat = ixc[..., 0]
        for d in range(1, D):
            flat = flat * ncell[d] + ixc[..., d]
        return torch.where(inb, flat, C)

    def cell_index(pos):
        return torch.floor((pos - lo) / cell).to(torch.int64)

    tracks = _Tracks(M, D, memory, dev)
    out, rounds, syncs = [], [], []
    for t in range(T):
        pos, ok = positions[t], valid[t]
        alive = tracks.age[:M] <= memory
        # bin tracks: per-cell lists of track indices (cap cell_cap)
        ix = cell_index(tracks.pos[:M])
        tcell = flat_cell(ix, ((ix >= 0) & (ix < nc)).all(-1) & alive)
        order = torch.argsort(tcell, stable=True)
        sorted_cells = tcell[order]
        start = torch.searchsorted(sorted_cells, ar_c, right=False)
        flat_idx = torch.clamp(start[:, None] + j_idx, 0, M - 1)
        lists = torch.where(sorted_cells[flat_idx] == ar_c[:, None],
                            order[flat_idx], M)            # [C, P]
        lists_pad = torch.cat(
            [lists, torch.full((1, cell_cap), M, dtype=lists.dtype,
                               device=dev)])
        # candidate tracks per feature: the 3^D neighbour cells
        fix = cell_index(pos)
        parts = []
        for o in offs:
            nx = fix + o
            inb = ((nx >= 0) & (nx < nc)).all(-1) & ok
            parts.append(lists_pad[flat_cell(nx, inb)])
        cand = torch.cat(parts, dim=1)                     # [K, Q]
        safe_cand = torch.clamp(cand, max=M - 1)
        d2 = _sq_dist(pos[:, None, :], tracks.pos[safe_cand])
        feasible = ((cand < M) & ok[:, None] & alive[safe_cand]
                    & (d2 <= r2max))
        d2 = torch.where(feasible, d2, _BIG)
        ft, r, s = _auction(d2, ok, r2max, eps, M, auction_rounds,
                            cand=cand)
        out.append(tracks.advance(ft, pos, ok))
        rounds.append(r)
        syncs.append(s)
    link_on_device_binned.last_stats = dict(frames=T, rounds=rounds,
                                            syncs=syncs)
    return torch.stack(out) if out else torch.zeros(
        (0, K), dtype=torch.int32, device=dev)


link_on_device_binned.last_stats = None
