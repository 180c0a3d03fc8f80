"""Cluster discovery on the device: connected components over coordinates.

Counterpart of ``clustertracking_tpu/ops/find.py`` (``connected_components``,
``cluster_sizes``), in plain torch on the coordinates' device.  The
contract is the reference's: clusters are connected components of the
"distance <= separation" graph (transitive chains merge), per-axis
separations by scaling each axis.

- Pair distances go row block by row block, through per-axis direct
  differences divided by ``sep[d]`` after the subtraction, in float64:
  the card has float64, so the reference's float32 hi/lo split is not
  carried over, and ``d2 <= 1`` decides a pair as the host's float64
  cKDTree does.  A block is [rows, N] float64, ``_BLOCK_BYTES`` at most.
- Components come from iterated min-label propagation (each point takes
  the minimum label among itself and its neighbours) with two pointer
  jumps per round, up to ``max_iter`` rounds; the host reads once a round
  whether any label changed.  Labels are root indices, and a root is the
  smallest index in its component.

Plain torch elementwise ops round each operation once (no multiply-add
contraction across ops), so ``diff * diff + d2`` is rounded as written.
``connected_components.last_rounds`` keeps the last call's round count.
"""
from __future__ import annotations

import torch

__all__ = ["connected_components", "cluster_sizes"]

# bytes of one [rows, N] float64 block of pair distances
_BLOCK_BYTES = 256 << 20


def _block_rows(N):
    return max(1, min(N, _BLOCK_BYTES // (8 * max(N, 1))))


def connected_components(coords, valid, separation, row_chunk=None,
                         max_iter: int = 64):
    """Label connected components of the <=separation overlap graph.

    Args:
      coords: [N, D] positions (float64 on the device that computes).
      valid: [N] bool, False for padding rows.
      separation: scalar or [D] per-axis separation.
      row_chunk: rows per distance block (None: as many as fit
        ``_BLOCK_BYTES``).
      max_iter: cap on propagate+jump rounds.

    Returns:
      labels: [N] int64 — root index per point (same value = same
        cluster); padding rows keep their own index.
    """
    coords = coords.to(torch.float64)
    dev = coords.device
    N, D = coords.shape
    # a device tensor: CUDA multiplies by the reciprocal of a host scalar
    sep = torch.broadcast_to(
        torch.as_tensor(separation, dtype=torch.float64, device=dev), (D,))
    valid = valid.to(dev)
    rows = row_chunk or _block_rows(N)
    inf = torch.iinfo(torch.int64).max
    labels = torch.arange(N, dtype=torch.int64, device=dev)
    rounds = 0
    while rounds < max_iter:
        mins = []
        for i0 in range(0, N, rows):
            xb, vb = coords[i0:i0 + rows], valid[i0:i0 + rows]
            d2 = None
            for d in range(D):
                diff = (xb[:, d, None] - coords[None, :, d]) / sep[d]
                d2 = diff * diff if d2 is None else d2 + diff * diff
            adj = (d2 <= 1.0) & valid[None, :] & vb[:, None]
            mins.append(torch.where(adj, labels[None, :], inf).amin(dim=1))
        mins = torch.cat(mins) if mins else labels
        new = torch.minimum(labels, torch.where(valid, mins, labels))
        new = new[new]        # pointer jumping (path halving)
        new = new[new]
        rounds += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    connected_components.last_rounds = rounds
    return labels


connected_components.last_rounds = None


def cluster_sizes(labels, valid):
    """Per-point size of its cluster (padding rows → 0)."""
    counts = torch.zeros(labels.shape[0], dtype=torch.int64,
                         device=labels.device)
    counts.index_add_(0, labels, valid.to(torch.int64))
    return torch.where(valid, counts[labels], 0)
