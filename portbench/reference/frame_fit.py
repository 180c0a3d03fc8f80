"""Plain reference of ``refine_leastsq`` on one frame's feature table.

The features are grouped into clusters (``clusters.components``), every
cluster of n features becomes a lane of the bucket of size n, started
from its rows (background 0, the rows' signal and positions, size
diameter/4), and the bucket is fitted by ``gauss_fit.fit`` in a window of
the bucket's bounding box plus the radius and a margin of 2·max_shift + 3,
in steps of 8 pixels, and no larger than the chain bound
ceil((n − 1)·separation + 2·radius) + 3.  A fit whose rms exceeds
``max_rms_dev`` is rejected: its rows keep their values and get no cost.
Buckets of more than 4 features, which the port pads to a ladder of
sizes, are not part of this reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import clusters, gauss_fit


def bucket_window(n, starts, radius, separation, max_shift, frame_shape):
    """The window a bucket of n-feature clusters is fitted in; ``starts``
    [B, n, 2] starting positions."""
    w = [min(int(math.ceil((n - 1) * s + 2 * r)) + 3, fs)
         for s, r, fs in zip(separation, radius, frame_shape)]
    if n == 1:
        return tuple(w)
    ext = (starts.max(axis=1) - starts.min(axis=1)).max(axis=0)
    margin = 2.0 * max_shift + 3.0
    return tuple(min(wd, max(8, int(-(-(e + 2 * r + margin) // 8) * 8)), fs)
                 for wd, e, r, fs in zip(w, ext, radius, frame_shape))


def lanes(ys, xs, separation):
    """(cluster ids [N], {n: [B, n] row indices}) of one frame."""
    ids = clusters.components(np.stack([ys, xs], axis=1), separation)
    by_size = {}
    for c in range(ids.max() + 1 if len(ids) else 0):
        rows = np.nonzero(ids == c)[0]
        by_size.setdefault(len(rows), []).append(rows)
    return ids, {n: np.array(r) for n, r in by_size.items()}


def fit_frames(frames, tables, config, precision="float32"):
    """Fit every table (dict of numpy ``y``, ``x``, ``signal``; one a
    frame of ``frames`` [T, H, W] on the device) as ``refine_leastsq``
    would.  Returns per table a dict of numpy ``y``, ``x``, ``signal``,
    ``cost`` (rms, NaN where rejected), ``converged``, ``cluster``, and
    the per-size ``rounds`` of the solve."""
    radius = tuple(config["diameter"] / 2.0 for _ in range(2))
    sep = (float(config["separation"]),) * 2
    size0 = float(np.mean(radius)) / 2.0
    frame_shape = tuple(frames.shape[1:])
    dev = frames.device
    plan = []
    for t, tab in enumerate(tables):
        ids, by_size = lanes(tab["y"], tab["x"], sep)
        if any(n > 4 for n in by_size):
            raise ValueError("clusters of more than 4 features are outside "
                             "this reference")
        plan.append((ids, by_size))
    out = []
    for t, tab in enumerate(tables):
        out.append(dict(y=tab["y"].astype(float).copy(),
                        x=tab["x"].astype(float).copy(),
                        signal=tab["signal"].astype(float).copy(),
                        cost=np.full(len(tab["y"]), np.nan),
                        converged=np.zeros(len(tab["y"]), bool),
                        cluster=plan[t][0], rounds={}))
    # the port sizes each frame's bucket on its own; frames whose buckets
    # get the same window are fitted as one batch of lanes
    groups = {}
    for t, tab in enumerate(tables):
        for n, rows in plan[t][1].items():
            p0 = np.zeros((len(rows), n, 5), np.float32)
            p0[:, :, 1] = tab["signal"][rows]
            p0[:, :, 2] = tab["y"][rows]
            p0[:, :, 3] = tab["x"][rows]
            p0[:, :, 4] = size0
            win = bucket_window(n, p0[:, :, 2:4].astype(float), radius, sep,
                                config["max_shift"], frame_shape)
            groups.setdefault((n, win), []).append((t, rows, p0))
    for (n, win), parts in sorted(groups.items()):
        p0 = np.concatenate([p for _, _, p in parts])
        fidx = np.concatenate([np.full(len(r), t, np.int32)
                               for t, r, _ in parts])
        B = len(p0)
        res = gauss_fit.fit(
            frames, torch.as_tensor(fidx, device=dev),
            torch.as_tensor(p0, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev), window=win,
            radius=radius, max_iter=config["max_iter"],
            max_shift=config["max_shift"], lm_max_iter=config["lm_max_iter"],
            ftol=config["ftol"], xtol=config["xtol"], precision=precision)
        rms_all = res["rms"].cpu().numpy()
        params_all = res["params"].cpu().numpy()
        conv_all = res["converged"].cpu().numpy()
        rounds_all = [{k: v.cpu().numpy() for k, v in r.items()}
                      for r in res["rounds"]]
        lo = 0
        for t, rows, _ in parts:
            sl = slice(lo, lo + len(rows))
            lo += len(rows)
            rms, params = rms_all[sl], params_all[sl]
            ok = np.isfinite(rms) & (rms <= config["max_rms_dev"])
            o = out[t]
            o["rounds"][n] = dict(window=win, rounds=[
                {k: v[sl] for k, v in r.items()} for r in rounds_all])
            r_ok = rows[ok]
            o["y"][r_ok] = params[ok, :, 2]
            o["x"][r_ok] = params[ok, :, 3]
            o["signal"][r_ok] = params[ok, :, 1]
            o["cost"][r_ok] = np.repeat(rms[ok, None], n, axis=1)
            o["converged"][rows] = np.repeat(conv_all[sl, None], n, axis=1)
    return out
