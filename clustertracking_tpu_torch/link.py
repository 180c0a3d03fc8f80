"""Frame-to-frame trajectory linking: ``link``, ``Linker``, ``filter_stubs``.

Counterpart of ``clustertracking_tpu/link.py``.  The host linker
(``Linker``, numpy and scipy) is a copy of the reference's, held to it bit
for bit: within every *subnet* (connected component of the candidate
bipartite graph of (track, feature) pairs closer than ``search_range``)
the assignment minimizes the total squared displacement, an unlinked
feature costing ``search_range²`` — trackpy's subnet objective, solved
exactly per subnet with the Hungarian algorithm
(scipy.optimize.linear_sum_assignment); equal-cost optima break ties
lowest feature index first.  The device linkers are the auctions of
``ops/link.py``, on the device ``link`` is given.  pandas is imported by
the functions that take DataFrames only.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from .utils import guess_pos_columns

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["link", "link_df", "filter_stubs", "Linker"]


def link(
    f: "pd.DataFrame",
    search_range: float,
    memory: int = 0,
    pos_columns: Optional[list] = None,
    t_column: str = "frame",
    backend: Optional[str] = None,
    mesh=None,
    device=None,
) -> "pd.DataFrame":
    """Assign a ``particle`` column linking features across frames.

    ``backend``:

    - None or 'host' (the default, as in the reference): the subnet-optimal
      ``Linker`` (Hungarian per connected component) on the host.  This is
      the reference's own default algorithm, exact per subnet, not a
      stand-in for a device path; ``particle`` is int64.
    - 'device': the auction on the dense [K, K·(memory+2)] cost matrix
      (``ops/link.py::link_on_device``), ε-optimal; ``particle`` int32.
    - 'device-binned': the auction on a spatially binned candidate graph
      (``link_on_device_binned``) for dense frames; ``particle`` int32.
    - 'auto': 'device' up to 2,048 features in the fullest frame, else
      'device-binned' (the reference's routing).

    ``device`` (device backends only): None is 'cuda', and raises
    ``RuntimeError`` where no CUDA device exists; pass ``device='cpu'`` to
    run the auction on the host.

    ``mesh`` (a ``parallel.sharding.make_mesh`` mesh): the video splits
    into one contiguous frame range per shard, each linked on its shard's
    device, and trajectories stitch across the cuts
    (``parallel/linking.py::link_sharded``).  ``backend`` then picks the
    in-shard auction ('auto', the default under a mesh, 'device' or
    'device-binned'; 'host' raises ``ValueError``); ``particle`` is
    int64.  Any other ``mesh`` raises ``TypeError``.

    The backend run is recorded in ``out.attrs['link_backend']``
    (``'sharded:<backend>'`` under a mesh).
    """
    if pos_columns is None:
        pos_columns = guess_pos_columns(f)
    if mesh is not None:
        from .refine import _mesh_device

        _mesh_device(mesh, None, "link")
    if backend is None:
        backend = "auto" if mesh is not None else "host"
    if backend == "auto":
        kmax = int(f.groupby(t_column).size().max()) if len(f) else 0
        # dense frames take the BINNED auction: the dense [K, K·(memory+2)]
        # matrix grows with K², the binned [K, 3^D·cell_cap] graph with K
        backend = "device" if kmax <= 2048 else "device-binned"
    if mesh is not None:
        # the host Linker is sequential in time: it has no sharded form
        if backend not in ("device", "device-binned"):
            raise ValueError(
                f"backend={backend!r} cannot run under mesh=; use "
                "'auto', 'device' or 'device-binned'"
            )
        out = _link_sharded_df(f, search_range, memory, pos_columns,
                               t_column, mesh, backend)
        out.attrs["link_backend"] = f"sharded:{backend}"
        return out
    if backend in ("device", "device-binned"):
        from .refine import _resolve_device

        out = _link_device(f, search_range, memory, pos_columns, t_column,
                           _resolve_device(device, "link"),
                           binned=backend == "device-binned")
        out.attrs["link_backend"] = backend
        return out
    if backend != "host":
        raise ValueError(f"Unknown backend {backend!r}")
    f = f.sort_values(t_column, kind="stable").copy()
    particle = np.full(len(f), -1, dtype=np.int64)

    linker = Linker(search_range, memory)
    frames = f.groupby(t_column, sort=True).indices
    positions_all = f[pos_columns].to_numpy(dtype=float)
    for t, idx in frames.items():
        particle[idx] = linker.advance(int(t), positions_all[idx])

    f["particle"] = particle
    f = f.sort_index()
    f.attrs["link_backend"] = "host"
    return f


class Linker:
    """Incremental subnet-optimal frame linker (host).

    Holds the active-track state between frames so linking can stream —
    the checkpoint/resume path (pipeline.track with ``checkpoint_dir``)
    serializes ``state()`` and resumes with ``from_state``.  ``link()``
    drives it over whole DataFrames; semantics are the module-docstring
    assignment contract (per-subnet minimum total squared displacement).
    """

    def __init__(self, search_range: float, memory: int = 0):
        self.search_range = float(search_range)
        self.memory = int(memory)
        self.track_pos: list = []
        self.track_id: list = []
        self.track_seen: list = []
        self.next_id = 0

    def advance(self, t: int, pos: np.ndarray) -> np.ndarray:
        """Link one frame's positions [k, D]; returns particle ids [k]."""
        from scipy.spatial import cKDTree

        k = len(pos)
        assigned = np.full(k, -1, dtype=np.int64)

        # retire stale tracks
        keep = [
            i for i, seen in enumerate(self.track_seen)
            if t - seen <= self.memory + 1
        ]
        self.track_pos = [self.track_pos[i] for i in keep]
        self.track_id = [self.track_id[i] for i in keep]
        self.track_seen = [self.track_seen[i] for i in keep]

        if self.track_pos and k:
            tp = np.asarray(self.track_pos)
            tree = cKDTree(tp)
            # every candidate (feature, track) pair within search_range
            cand_lists = tree.query_ball_point(pos, r=self.search_range)

            # subnets = connected components of the candidate bipartite
            # graph (union-find over features ∪ tracks)
            parent = {}

            def find(a):
                while parent.setdefault(a, a) != a:
                    parent[a] = parent[parent[a]]
                    a = parent[a]
                return a

            def union(a, b):
                parent[find(a)] = find(b)

            for j, tis in enumerate(cand_lists):
                for ti in tis:
                    union(("f", j), ("t", ti))
            subnets = {}
            for j, tis in enumerate(cand_lists):
                if not tis:
                    continue
                root = find(("f", j))
                feats, tracks = subnets.setdefault(root, ([], set()))
                feats.append(j)
                tracks.update(tis)

            sr2 = self.search_range ** 2
            from scipy.optimize import linear_sum_assignment

            for feats, tracks in subnets.values():
                tracks = sorted(tracks)
                F, Tn = len(feats), len(tracks)
                # trackpy subnet objective: min Σ cost where a linked
                # feature costs d² and an unlinked one costs SR²; tracks
                # may go unmatched free.  Columns = tracks + one null
                # per feature.
                cost = np.full((F, Tn + F), 4.0 * sr2)
                for r, j in enumerate(feats):
                    cost[r, Tn + r] = sr2
                    for c, ti in enumerate(tracks):
                        d2 = float(np.sum((pos[j] - tp[ti]) ** 2))
                        if d2 <= sr2:
                            cost[r, c] = d2
                rows, cols = linear_sum_assignment(cost)
                for r, c in zip(rows, cols):
                    if c < Tn and cost[r, c] <= sr2:
                        j, ti = feats[r], tracks[c]
                        assigned[j] = self.track_id[ti]
                        self.track_pos[ti] = pos[j]
                        self.track_seen[ti] = t

        for j in range(k):
            if assigned[j] < 0:
                assigned[j] = self.next_id
                self.track_pos.append(pos[j])
                self.track_id.append(self.next_id)
                self.track_seen.append(t)
                self.next_id += 1
        return assigned

    def state(self) -> dict:
        """JSON-serializable snapshot of the active tracks."""
        return {
            "search_range": self.search_range,
            "memory": self.memory,
            "track_pos": np.asarray(
                self.track_pos, dtype=float
            ).tolist(),
            "track_id": list(map(int, self.track_id)),
            "track_seen": list(map(int, self.track_seen)),
            "next_id": int(self.next_id),
        }

    @classmethod
    def from_state(cls, state: dict) -> "Linker":
        lk = cls(state["search_range"], state["memory"])
        lk.track_pos = [
            np.asarray(p, dtype=float) for p in state["track_pos"]
        ]
        lk.track_id = list(state["track_id"])
        lk.track_seen = list(state["track_seen"])
        lk.next_id = int(state["next_id"])
        return lk


def _pad_frames(f, pos_columns, t_column):
    """Pad per-frame features to static [T, K, D] arrays + row slots.

    The padded time axis covers EVERY frame in [min, max] — empty frames
    must occupy time slots or gaps would not count against ``memory``.
    Rows fill their frame's slots in row order; padding sits at 1e8."""
    tcol = f[t_column].to_numpy().astype(np.int64)
    tmin, tmax = int(tcol.min()), int(tcol.max())
    T = tmax - tmin + 1
    ti = tcol - tmin
    counts = np.bincount(ti, minlength=T)
    K = int(counts.max())
    D = len(pos_columns)
    # each row's rank within its frame, in row order
    order = np.argsort(ti, kind="stable")
    first = np.cumsum(counts) - counts
    k = np.empty(len(f), dtype=np.int64)
    k[order] = np.arange(len(f)) - first[ti[order]]
    positions = np.full((T, K, D), 1e8, dtype=np.float32)
    valid = np.zeros((T, K), dtype=bool)
    positions[ti, k] = f[pos_columns].to_numpy(dtype=np.float32)
    valid[ti, k] = True
    return positions, valid, ti * K + k


def _link_device(f, search_range, memory, pos_columns, t_column, device,
                 binned=False):
    """Pad per-frame features to a static K and run ``ops/link.py``'s
    auction on ``device``."""
    import torch

    from .ops.link import link_on_device, link_on_device_binned

    f = f.copy()
    if len(f) == 0:
        f["particle"] = np.array([], dtype=np.int64)
        return f
    positions, valid, slots = _pad_frames(f, pos_columns, t_column)
    pos_t = torch.as_tensor(positions, device=device)
    valid_t = torch.as_tensor(valid, device=device)
    if binned:
        # cell-grid bounds from the data, quantized to multiples of 64 px
        # (the reference's, which shares one compiled scan between
        # same-sized videos)
        pos_real = f[pos_columns].to_numpy(dtype=float)
        bounds = tuple(
            (
                float(np.floor(pos_real[:, d].min() / 64.0) * 64.0),
                float(np.ceil((pos_real[:, d].max() + 1) / 64.0) * 64.0),
            )
            for d in range(len(pos_columns))
        )
        particles = link_on_device_binned(
            pos_t, valid_t, float(search_range), int(memory), bounds=bounds)
    else:
        particles = link_on_device(pos_t, valid_t, float(search_range),
                                   int(memory))
    f["particle"] = particles.cpu().numpy().reshape(-1)[slots]
    return f


def _link_sharded_df(f, search_range, memory, pos_columns, t_column, mesh,
                     backend):
    """Frame-sharded linking over ``mesh`` (parallel/linking.py)."""
    from .parallel.linking import link_sharded

    f = f.copy()
    if len(f) == 0:
        f["particle"] = np.array([], dtype=np.int64)
        return f
    positions, valid, slots = _pad_frames(f, pos_columns, t_column)
    parts = link_sharded(
        positions, valid, float(search_range), int(memory), mesh=mesh,
        backend=backend,
    ).reshape(-1)
    f["particle"] = parts[slots]
    return f


def filter_stubs(
    f: "pd.DataFrame",
    threshold: int = 10,
    t_column: str = "frame",
) -> "pd.DataFrame":
    """Drop trajectories seen in fewer than ``threshold`` frames.

    The trackpy post-link utility: spurious detections and fragments
    produce short tracks that poison diffusion statistics.  Requires a
    ``particle`` column (run ``link`` first)."""
    if "particle" not in f.columns:
        raise ValueError("filter_stubs needs a 'particle' column — "
                         "link the features first")
    counts = f.groupby("particle")[t_column].nunique()
    keep = counts[counts >= threshold].index
    return f[f["particle"].isin(keep)]


# Reference-compatible alias (trackpy.link_df name)
link_df = link
