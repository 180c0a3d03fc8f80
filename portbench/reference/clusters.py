"""Plain reference of cluster finding: features closer than the
separation (per axis, scaled) belong to one cluster, transitively, within
a frame.  Labels are consecutive ids in order of first appearance."""
from __future__ import annotations

import numpy as np


def components(coords, separation):
    """[N] cluster ids of one frame's [N, D] coordinates."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    c = np.asarray(coords, float) / np.asarray(separation, float)
    N = len(c)
    if N == 0:
        return np.zeros(0, np.int64)
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(axis=-1)
    i, j = np.nonzero(np.triu(d2 <= 1.0, k=1))
    graph = coo_matrix((np.ones(len(i)), (i, j)), shape=(N, N))
    _, labels = connected_components(graph, directed=False)
    return canonical(labels)


def canonical(labels):
    """Labels renumbered 0, 1, ... in order of first appearance."""
    labels = np.asarray(labels)
    _, first = np.unique(labels, return_index=True)
    order = np.argsort(first)
    remap = np.empty(len(order), np.int64)
    remap[order] = np.arange(len(order))
    _, inv = np.unique(labels, return_inverse=True)
    return remap[inv]
