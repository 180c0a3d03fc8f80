"""find_clusters — DataFrame API for cluster discovery.

Counterpart of ``clustertracking_tpu/find.py``: groups candidate feature
coordinates into clusters by transitive <=separation overlap, per frame,
adding ``cluster`` (int id, consecutive within the DataFrame) and
``cluster_size`` columns.  Backends: ``'host'`` (cKDTree + union-find) or
``'device'`` (float64 label propagation, ``ops/find.py``); both give the
same groupings, and ids are canonicalized to first-appearance order, so
the outputs match exactly.  pandas is imported by ``find_clusters`` only.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from .utils import guess_pos_columns, validate_tuple

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["Clusters", "find_clusters", "host_connected_components"]

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
    cluster)."""
    from scipy.spatial import cKDTree

    coords = np.asarray(coords, dtype=float)
    N, D = coords.shape
    sep = np.broadcast_to(np.asarray(separation, dtype=float), (D,))
    parent = np.arange(N)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    if N:
        tree = cKDTree(coords / sep)
        for i, j in tree.query_pairs(1.0):
            ri, rj = find(i), find(j)
            if ri != rj:
                if ri < rj:
                    parent[rj] = ri
                else:
                    parent[ri] = rj
    return np.array([find(i) for i in range(N)])


def _canonicalize(labels: np.ndarray) -> np.ndarray:
    """Root labels → consecutive ids in order of first appearance."""
    out = np.empty(len(labels), dtype=np.int64)
    mapping = {}
    for i, lab in enumerate(labels):
        if lab not in mapping:
            mapping[lab] = len(mapping)
        out[i] = mapping[lab]
    return out


def _labels_device(coords: np.ndarray, separation, device) -> np.ndarray:
    """Root labels of one frame's coordinates by the device label
    propagation on ``device``."""
    import torch

    from .ops.find import connected_components

    x = torch.tensor(coords, dtype=torch.float64, device=device)
    valid = torch.ones(len(coords), dtype=torch.bool, device=device)
    return connected_components(x, valid, separation).cpu().numpy()


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
    'device' (label propagation on ``device``) or 'auto' (the device path
    for frames of at least ``_DEVICE_MIN_FEATURES`` candidates, the host
    for smaller ones).  ``device``: None is 'cuda', and raises
    ``RuntimeError`` where no CUDA device exists (with 'auto', only once a
    frame that large comes); pass ``device='cpu'`` to propagate on the
    host.
    """
    if backend not in ("host", "auto", "device"):
        raise ValueError(f"Unknown backend {backend!r}")
    if pos_columns is None:
        pos_columns = guess_pos_columns(f)
    ndim = len(pos_columns)
    separation = validate_tuple(separation, ndim)

    f = f.copy()
    f["cluster"] = -1
    if t_column in f.columns:
        groups = f.groupby(t_column, sort=False).indices.items()
    else:
        groups = [(0, np.arange(len(f)))]

    next_id = 0
    cluster_col = np.full(len(f), -1, dtype=np.int64)
    for _, idx in groups:
        coords = f.iloc[idx][pos_columns].to_numpy(dtype=float)
        if backend == "device" or (
                backend == "auto" and len(coords) >= _DEVICE_MIN_FEATURES):
            from .refine import _resolve_device

            labels = _labels_device(
                coords, separation, _resolve_device(device, "find_clusters"))
        else:
            labels = host_connected_components(coords, separation)
        ids = _canonicalize(labels) + next_id
        cluster_col[idx] = ids
        next_id = ids.max() + 1 if len(ids) else next_id

    f["cluster"] = cluster_col
    sizes = f.groupby("cluster")["cluster"].transform("size")
    f["cluster_size"] = sizes.astype(np.int64)
    return f
