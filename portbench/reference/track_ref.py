"""Plain reference of ``track``: locate, cluster finding, fit and linking
over a video, single shot, no recovery pass.

1. ``locate.locate`` on every frame, with the locate separation half the
   cluster separation per axis (rounded, at least 2 px), as ``track``'s
   docstring states.
2. ``clusters.components`` per frame on the candidates, at the
   separation.
3. The fit: every cluster of n features is a lane of its chunk of
   ``frames_per_dispatch`` frames (the frames that hold candidates, in
   order), started from its rows (background 0, the candidate's pixel as
   signal, its position, its located size, held), and fitted by
   ``gauss_fit.fit`` in the window that ``frame_fit.bucket_window`` gives
   the chunk's bucket.  Up to 4 features a bucket holds one cluster size;
   past 4, ``refine_leastsq`` buckets sizes up to a ladder step (5 and 6
   in the bucket of 6, 7 and 8 in that of 8) and pads each cluster with
   features that add nothing, so the window is the one of the step over
   every lane of its bucket, and each size is fitted at that window.
   Lanes of every chunk and every video that share a size and a window
   are fitted as one batch.  A fit whose rms exceeds ``max_rms_dev`` (or
   is not finite) is rejected and its rows leave the output.
4. ``link.link`` on the accepted rows of each frame.

Clusters of more than ``max_cluster_size`` (8) features, which the port
fits one by one with scipy on the host, are outside this reference: their
rows stay at their located positions, unfitted (``fitted`` False), and
are linked there.  This imports nothing of the port and nothing of JAX;
the fit's sums take ``precision`` ('float32', 'tf32', 'bfloat16') as
``gauss_fit`` does, and TF32 is off for every matmul and convolution of
the process.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import clusters, frame_fit, gauss_fit, link, locate

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MAX_FITTED = 8          # refine_leastsq's max_cluster_size
LADDER = (1, 2, 3, 4, 6, 8)


def bucket_of(n):
    """The ladder step a cluster of n <= MAX_FITTED features is fitted in."""
    return next(b for b in LADDER if b >= n)


def locate_separation(separation):
    return tuple(max(2, int(round(s / 2))) for s in separation)


def _located(video, config):
    """One video's candidates and clusters, as flat arrays."""
    D = video.ndim - 1
    diam = (float(config["diameter"]),) * D
    sep = (float(config["separation"]),) * D
    loc_sep = locate_separation(sep)
    cols = {k: [] for k in ("frame", "pos", "signal", "size", "cluster")}
    offset = 0
    for t in range(len(video)):
        c = locate.locate(video[t], diam, loc_sep,
                          percentile=config["percentile"],
                          max_features=config["max_features"])
        ids = clusters.components(c["coords"], sep)
        cols["frame"].append(np.full(len(ids), t, np.int64))
        cols["pos"].append(c["coords"].reshape(-1, D))
        cols["signal"].append(c["signal"])
        cols["size"].append(c["size"])
        cols["cluster"].append(ids + offset)
        offset += int(ids.max()) + 1 if len(ids) else 0
    out = {k: np.concatenate(v) for k, v in cols.items()}
    out["cluster_size"] = np.bincount(out["cluster"])[out["cluster"]] \
        if len(out["cluster"]) else np.zeros(0, np.int64)
    return out


def track(videos, config, device, precision="float32"):
    """``track`` on each video ([T, H, W] float32, host) of ``videos``.
    Returns one dict a video of numpy columns, one row a candidate:
    ``frame``, ``y``, ``x``, ``signal``, ``size``, ``cluster``,
    ``cluster_size``, ``located`` [N, 2], ``cost`` (the fit's rms; NaN
    where rejected or not fitted), ``converged``, ``fitted``, ``kept``
    (in the linked output) and ``particle`` (-1 where not kept)."""
    rad = float(config["diameter"]) / 2.0
    radius = (rad, rad)
    sep = (float(config["separation"]),) * 2
    per = int(config["frames_per_dispatch"])
    shape = tuple(videos[0].shape[1:])
    tabs = [_located(v, config) for v in videos]
    groups = {}
    base = 0
    for v, tab in enumerate(tabs):
        present, rank = np.unique(tab["frame"], return_inverse=True)
        chunk = rank.reshape(-1) // per
        for c in np.unique(chunk):
            for b in LADDER:
                sizes = [n for n in range(1, b + 1) if bucket_of(n) == b]
                parts = []
                for n in sizes:
                    rows = np.flatnonzero((chunk == c)
                                          & (tab["cluster_size"] == n))
                    if len(rows):
                        rows = rows[np.argsort(tab["cluster"][rows],
                                               kind="stable")]
                        parts.append((n, rows.reshape(-1, n)))
                if not parts:
                    continue
                # each lane's starts padded to the step with its first
                # feature, which leaves its extent as it is
                starts = np.concatenate([
                    tab["pos"][lanes][:, np.r_[np.arange(n),
                                               np.zeros(b - n, int)]]
                    for n, lanes in parts])
                win = frame_fit.bucket_window(b, starts, radius, sep,
                                              config["max_shift"], shape)
                for n, lanes in parts:
                    p0 = np.zeros((len(lanes), n, 5), np.float32)
                    p0[:, :, 1] = tab["signal"][lanes]
                    p0[:, :, 2:4] = tab["pos"][lanes]
                    p0[:, :, 4] = tab["size"][lanes]
                    fidx = base + tab["frame"][lanes[:, 0]]
                    groups.setdefault((n, win), []).append(
                        (v, lanes, p0, fidx))
        base += len(videos[v])
    frames = torch.as_tensor(np.concatenate(videos), device=device)
    for t in tabs:
        N = len(t["frame"])
        t["y"], t["x"] = t["pos"][:, 0].copy(), t["pos"][:, 1].copy()
        t["cost"] = np.full(N, np.nan)
        t["converged"] = np.zeros(N, bool)
        t["fitted"] = t["cluster_size"] <= MAX_FITTED
    for (n, win), parts in sorted(groups.items()):
        p0 = np.concatenate([p for _, _, p, _ in parts])
        fidx = np.concatenate([f for _, _, _, f in parts]).astype(np.int32)
        res = gauss_fit.fit(
            frames, torch.as_tensor(fidx, device=device),
            torch.as_tensor(p0, device=device),
            torch.ones(len(p0), dtype=torch.bool, device=device),
            window=win, radius=radius, max_iter=config["max_iter"],
            max_shift=config["max_shift"], lm_max_iter=config["lm_max_iter"],
            ftol=config["ftol"], xtol=config["xtol"], precision=precision)
        params = res["params"].cpu().numpy()
        rms = res["rms"].cpu().numpy()
        conv = res["converged"].cpu().numpy()
        lo = 0
        for v, lanes, _, _ in parts:
            sl = slice(lo, lo + len(lanes))
            lo += len(lanes)
            t = tabs[v]
            t["y"][lanes] = params[sl, :, 2]
            t["x"][lanes] = params[sl, :, 3]
            t["signal"][lanes] = params[sl, :, 1]
            t["cost"][lanes] = np.repeat(rms[sl, None], n, axis=1)
            t["converged"][lanes] = np.repeat(conv[sl, None], n, axis=1)
    out = []
    for v, t in enumerate(tabs):
        ok = np.isfinite(t["cost"]) & (t["cost"] <= config["max_rms_dev"])
        t["kept"] = ok | ~t["fitted"]
        pos = np.stack([t["y"], t["x"]], axis=1)
        T = len(videos[v])
        per_frame = [np.flatnonzero(t["kept"] & (t["frame"] == f))
                     for f in range(T)]
        ids = link.link([pos[r] for r in per_frame],
                        config["search_range"], config["memory"])
        t["particle"] = np.full(len(pos), -1, np.int64)
        for r, i in zip(per_frame, ids):
            t["particle"][r] = i
        t["located"] = t.pop("pos")
        out.append(t)
    return out
