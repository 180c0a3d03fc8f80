"""find_clusters — DataFrame API for cluster discovery.

Counterpart of ``clustertracking_tpu/find.py``: groups candidate feature
coordinates into clusters by transitive <=separation overlap, per frame,
adding ``cluster`` (int id, consecutive within the DataFrame) and
``cluster_size`` columns.  Backends: ``'host'`` (cKDTree + union-find on
arrays) or ``'device'`` (float64 label propagation, ``ops/find.py``);
both give the same groupings, and ids are canonicalized to
first-appearance order, so the outputs match exactly.  ``cluster_ids`` is
the grouping on arrays, which ``refine_leastsq`` calls directly; pandas is
imported by ``find_clusters`` only.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from .utils import guess_pos_columns, validate_tuple

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["Clusters", "cluster_ids", "find_clusters",
           "host_connected_components"]

# 'auto' routing: frames with at least this many candidates take the
# device label propagation.  The reference's threshold, kept for parity of
# routing; chip_smoke.py's [find] prints the card's times against the host.
_DEVICE_MIN_FEATURES = 100_000


class Clusters:
    """Union-find bookkeeping over feature indices.

    Start with every index in its own cluster, merge overlapping pairs,
    read back per-index cluster ids (canonicalized to first appearance)
    and sizes.
    """

    def __init__(self, indices):
        self.indices = list(indices)
        self._parent = {int(i): int(i) for i in self.indices}

    def _find(self, a: int) -> int:
        p = self._parent
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        return a

    def add_pair(self, a: int, b: int) -> None:
        """Merge the clusters containing features a and b."""
        ra, rb = self._find(int(a)), self._find(int(b))
        if ra != rb:
            # deterministic: smaller root wins (first-appearance order)
            lo, hi = (ra, rb) if ra < rb else (rb, ra)
            self._parent[hi] = lo

    def add_pairs(self, pairs) -> None:
        for a, b in pairs:
            self.add_pair(a, b)

    @property
    def cluster_id(self) -> dict:
        """index → consecutive cluster id, in first-appearance order."""
        out = {}
        mapping = {}
        for i in self.indices:
            r = self._find(int(i))
            if r not in mapping:
                mapping[r] = len(mapping)
            out[int(i)] = mapping[r]
        return out

    @property
    def cluster_size(self) -> dict:
        """index → size of its cluster."""
        ids = self.cluster_id
        counts: dict = {}
        for cid in ids.values():
            counts[cid] = counts.get(cid, 0) + 1
        return {i: counts[cid] for i, cid in ids.items()}

    def __len__(self) -> int:
        return len({self._find(int(i)) for i in self.indices})


def host_connected_components(coords: np.ndarray, separation) -> np.ndarray:
    """cKDTree pairs + union-find: root label per point (same value = same
    cluster), the smallest index of each component.

    The union-find runs on arrays: every pair whose roots differ hooks the
    larger root onto the smaller, then pointer jumping flattens every
    point onto its root, until no pair is split.  Pointers only ever go
    to smaller indices, so each component's smallest index stays its
    root."""
    from scipy.spatial import cKDTree

    coords = np.asarray(coords, dtype=float)
    N, D = coords.shape
    sep = np.broadcast_to(np.asarray(separation, dtype=float), (D,))
    parent = np.arange(N)
    if N:
        pairs = cKDTree(coords / sep).query_pairs(1.0, output_type="ndarray")
        i, j = pairs[:, 0], pairs[:, 1]
        while len(i):
            ri, rj = parent[i], parent[j]
            split = ri != rj
            i, j, ri, rj = i[split], j[split], ri[split], rj[split]
            np.minimum.at(parent, np.maximum(ri, rj), np.minimum(ri, rj))
            while True:
                up = parent[parent]
                if np.array_equal(up, parent):
                    break
                parent = up
    return parent


def _canonicalize(labels: np.ndarray) -> np.ndarray:
    """Root labels → consecutive ids in order of first appearance."""
    labels = np.asarray(labels)
    if not len(labels):
        return np.zeros(0, dtype=np.int64)
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.reshape(-1)]


def _labels_device(coords: np.ndarray, separation, device) -> np.ndarray:
    """Root labels of one frame's coordinates by the device label
    propagation on ``device``."""
    import torch

    from .ops.find import connected_components

    x = torch.tensor(coords, dtype=torch.float64, device=device)
    valid = torch.ones(len(coords), dtype=torch.bool, device=device)
    return connected_components(x, valid, separation).cpu().numpy()


def cluster_ids(coords: np.ndarray, frames: Optional[np.ndarray], separation,
                backend: str = "host", device=None):
    """The array core of ``find_clusters``: ``(cluster [N] int64,
    cluster_size [N] int64)`` for coordinates ``coords`` [N, D] in frames
    ``frames`` [N] (None: one frame), grouped within each frame.

    Ids are consecutive over the frames in order of first appearance and,
    within a frame, over its clusters in order of first appearance; rows
    whose frame is NaN stay in no cluster (id -1).  ``separation`` is a
    tuple of D; ``backend`` and ``device`` as ``find_clusters``'s."""
    if backend not in ("host", "auto", "device"):
        raise ValueError(f"Unknown backend {backend!r}")
    coords = np.asarray(coords, dtype=float)
    N = len(coords)
    cluster = np.full(N, -1, dtype=np.int64)
    keep = np.arange(N)
    if frames is None:
        frame_of = np.zeros(N, dtype=np.int64)
    else:
        frames = np.asarray(frames)
        if frames.dtype.kind == "f":
            keep = np.flatnonzero(~np.isnan(frames))
        frame_of = _canonicalize(frames[keep])
    # one stable sort groups the rows by frame, frames in order of first
    # appearance, rows in table order within each
    order = keep[np.argsort(frame_of, kind="stable")]
    groups = (np.split(order, np.cumsum(np.bincount(frame_of))[:-1])
              if len(order) else [])
    next_id = 0
    for idx in groups:
        if backend == "device" or (
                backend == "auto" and len(idx) >= _DEVICE_MIN_FEATURES):
            from .utils.device import _resolve_device

            labels = _labels_device(
                coords[idx], separation,
                _resolve_device(device, "find_clusters"))
        else:
            labels = host_connected_components(coords[idx], separation)
        ids = _canonicalize(labels) + next_id
        cluster[idx] = ids
        next_id = ids.max() + 1
    sizes = np.bincount(cluster + 1)[cluster + 1].astype(np.int64)
    return cluster, sizes


def find_clusters(
    f: "pd.DataFrame",
    separation,
    pos_columns: Optional[list] = None,
    t_column: str = "frame",
    backend: str = "host",
    device=None,
) -> "pd.DataFrame":
    """Assign ``cluster`` / ``cluster_size`` columns (per frame).

    Clusters are connected components of the "pairwise distance <=
    separation" graph (transitive chains merge); ``separation`` may be
    scalar or per-axis.  ``backend``: 'host' (cKDTree + union-find),
    'device' (label propagation on ``device``) or 'auto' (the
    device path for frames of at least ``_DEVICE_MIN_FEATURES``
    candidates, the host for smaller ones).  ``device``: None is 'cuda',
    and raises ``RuntimeError`` where no CUDA device exists (with 'auto',
    only once a frame that large comes); pass ``device='cpu'`` to
    propagate on the host.  The grouping itself is ``cluster_ids``, on
    arrays.
    """
    if pos_columns is None:
        pos_columns = guess_pos_columns(f)
    separation = validate_tuple(separation, len(pos_columns))
    frames = f[t_column].to_numpy() if t_column in f.columns else None
    coords = np.stack([f[c].to_numpy(dtype=float) for c in pos_columns],
                      axis=1)
    cluster, sizes = cluster_ids(coords, frames, separation, backend, device)
    f = f.copy()
    f["cluster"] = cluster
    f["cluster_size"] = sizes
    return f
