"""Driver ``track``: the port's ``track`` on one video a call.

Set-up draws a pool of videos of the configuration's scene
(``gen/brownian_video.py``) from the seed on the card and keeps them on
the host, as float32 frames that a reader from disk hands over; each
video is tracked once to build the kernels and warm every shape the
window will meet.  The window calls ``track(reader, diameter,
separation, search_range, memory, link_backend, device)`` on the pool's
videos in turn, one caller, each call timed until its DataFrame is
returned: locate, cluster finding, the fit and the device auction, the
frames' upload included.  Each call's loss ledger
(``diagnostics.collect``) gives the stage walls and the auction's rounds
and host syncs.  After the window the last output of every video the
window tracked is held to ``reference/track_ref.py`` on the same frames.
"""
from __future__ import annotations

import numpy as np
import torch

from core import Check
from gen import brownian_video
from reference import compare, track_ref

# the traffic entries that shrink this driver's cells to the host
HOST_TRAFFIC = {"videos": 1, "frames": 8}
ALTER_PX = 0.01    # one row moved by a hundredth of a pixel
LEDGER = ("locate_s", "fit_s", "link_s", "link_rounds", "link_syncs")


def make(cell, config, seed, device):
    return Track(cell, config, seed, device)


def plant(driver, fault):
    """Wrap the driver's ``track`` so that each call suffers ``fault``:
    ``"unchanged"`` (every row back on the pixel locate put it on: the fit
    returned its start), ``"half"`` (the rows of every other frame
    dropped) or ``"altered"`` (one row moved by ``ALTER_PX`` in x)."""
    driver.track = broken_track(driver.track, fault)


def broken_track(track, fault):
    def call(reader, **kw):
        out = track(reader, **kw)
        if fault == "unchanged":
            out[["y", "x"]] = np.round(out[["y", "x"]].to_numpy())
        elif fault == "half":
            out = out[out["frame"].to_numpy() % 2 == 0]
        else:
            out.loc[out.index[0], "x"] += ALTER_PX
        return out
    return call


class _Reader:
    """A video's host frames, one ``reader[t]`` a frame."""

    def __init__(self, frames):
        self.frames = frames

    def __getitem__(self, t):
        return self.frames[t]

    def __len__(self):
        return len(self.frames)


def _match(a, b, radius):
    """Pairs (i, j) of rows of ``a`` [n, D] and ``b`` [m, D] that minimise
    the summed squared distance, each pair within ``radius``."""
    from scipy.optimize import linear_sum_assignment

    if not len(a) or not len(b):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    far = d2 > radius * radius
    i, j = linear_sum_assignment(np.where(far, 1e6, d2))
    keep = ~far[i, j]
    return i[keep], j[keep]


def _same_trajectories(pa, pr):
    """Per matched pair: whether its trajectory on one side (the matched
    pairs that share its particle there) is the one on the other side."""
    def groups(ids):
        _, inv = np.unique(ids, return_inverse=True)
        members = {}
        for k, g in enumerate(inv.reshape(-1)):
            members.setdefault(g, []).append(k)
        return inv.reshape(-1), {g: frozenset(m) for g, m in members.items()}

    ga, ma = groups(pa)
    gr, mr = groups(pr)
    return np.array([ma[ga[k]] == mr[gr[k]] for k in range(len(pa))], bool)


class Track:
    def __init__(self, cell, config, seed, device):
        from clustertracking_tpu_torch import diagnostics, track

        self.cell, self.config, self.device = cell, config, device
        self.diagnostics = diagnostics
        mix = cell["mix"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.frames, _ = brownian_video.draw(
            mix["videos"], mix["frames"], tuple(config["frame_shape"]),
            dimers=config["dimers"], bond=config["bond"],
            size=config["size"], signal=config["signal"],
            noise=config["noise"], step=config["step"],
            angle_step=config["angle_step"], margin=config["margin"],
            clip=config["clip"], generator=gen, device=device)
        self.track = track
        self.kw = dict(diameter=config["diameter"],
                       separation=config["separation"],
                       search_range=config["search_range"],
                       memory=config["memory"],
                       link_backend=config["link_backend"], device=device)
        for v in range(len(self.frames)):   # build, warm every video
            self.track(_Reader(self.frames[v]), **self.kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.last = {}
        self.records = {k: [] for k in LEDGER}

    def call(self, i):
        v = i % len(self.frames)
        with self.diagnostics.collect() as stats:
            with torch.profiler.record_function("portbench.track"):
                out = self.track(_Reader(self.frames[v]), **self.kw)
        self.last[v] = out
        for k in LEDGER:
            self.records[k].append(stats.ledger.get(k))
        pairs = len(out[["frame", "cluster"]].drop_duplicates())
        return {"clusters": pairs, "video": v}

    def close(self):
        self.out = self.last
        self.last = {}

    def reference(self, keys, precision):
        res = track_ref.track([self.frames[k] for k in keys], self.config,
                              self.device, precision)
        return dict(zip(keys, res))

    def program_fits(self):
        return {k: dict(frame=o["frame"].to_numpy(np.int64),
                        y=o["y"].to_numpy(float), x=o["x"].to_numpy(float),
                        cost=o["cost"].to_numpy(float),
                        cluster_size=o["cluster_size"].to_numpy(np.int64),
                        particle=o["particle"].to_numpy(np.int64))
                for k, o in self.out.items()}

    def as_fits(self, ref):
        return {k: {c: r[c][r["kept"]] for c in
                    ("frame", "y", "x", "cost", "cluster_size", "particle")}
                for k, r in ref.items()}

    def gaps(self, fits, ref):
        """The rows of each video matched frame by frame: fitted rows
        within ``match_px`` (Hungarian on squared distance), rows of
        clusters of more than 8 features (which the port fits with scipy
        on the host and the reference leaves unfitted) within
        ``big_match_px`` of their located position.  ``rows_unmatched``:
        the share of rows on either side without a partner; ``rows_off``
        and the position gaps: compare.summary over matched fitted rows;
        ``traj_differ``: the share of matched rows whose trajectory, as
        the set of its matched rows, is not the same on both sides;
        ``rows_off_least_video``: the least, over the videos, of the share
        of a video's matched fitted rows that are off.  A fault of the
        path repeats in every call, so every video shows it; the rows that
        a last bit decides (0 to 2 of ~40,000) fall in one video or two."""
        chk = self.cell["check"]
        big = track_ref.MAX_FITTED
        pos_gap, rms_gap, traj, least = [], [], [], []
        n_rows = n_unmatched = n_big = 0
        for k in sorted(fits):
            n_gaps = len(pos_gap)
            a, r = fits[k], ref[k]
            keep = r["kept"]
            ra = {c: r[c][keep] for c in ("frame", "y", "x", "cost",
                                          "cluster_size", "particle")}
            pa_all, pr_all = [], []
            for t in np.union1d(np.unique(a["frame"]), np.unique(ra["frame"])):
                ia = np.flatnonzero(a["frame"] == t)
                ir = np.flatnonzero(ra["frame"] == t)
                for sel_big, radius in ((False, chk["match_px"]),
                                        (True, chk["big_match_px"])):
                    ja = ia[(a["cluster_size"][ia] > big) == sel_big]
                    jr = ir[(ra["cluster_size"][ir] > big) == sel_big]
                    i, j = _match(np.stack([a["y"][ja], a["x"][ja]], 1),
                                  np.stack([ra["y"][jr], ra["x"][jr]], 1),
                                  radius)
                    n_rows += len(ja) + len(jr)
                    n_unmatched += len(ja) + len(jr) - 2 * len(i)
                    pa_all.append(a["particle"][ja[i]])
                    pr_all.append(ra["particle"][jr[j]])
                    if sel_big:
                        n_big += len(jr)
                        continue
                    ma, mr = ja[i], jr[j]
                    pos_gap.append(np.maximum(
                        np.abs(a["y"][ma] - ra["y"][mr]),
                        np.abs(a["x"][ma] - ra["x"][mr])))
                    rms_gap.append(np.abs(a["cost"][ma] - ra["cost"][mr])
                                   / np.abs(ra["cost"][mr]))
            traj.append(_same_trajectories(np.concatenate(pa_all),
                                           np.concatenate(pr_all)))
            vp = np.concatenate(pos_gap[n_gaps:])
            vr = np.concatenate(rms_gap[n_gaps:])
            off = ~(np.isfinite(vp) & np.isfinite(vr)) | (
                vp > chk["tol_px"]) | (vr > chk["tol_rms"])
            least.append(float(np.mean(off)) if len(off) else 0.0)
        pos_gap = np.concatenate(pos_gap)
        out = compare.summary(pos_gap, np.concatenate(rms_gap),
                              np.zeros(len(pos_gap), bool),
                              tol_px=chk["tol_px"], tol_rms=chk["tol_rms"])
        out["rows_off"] = out.pop("lanes_off")
        out["rows_matched"] = out.pop("lanes")
        out.pop("converged_differ")
        traj = np.concatenate(traj)
        out["rows_off_least_video"] = min(least)
        out["rows_unmatched"] = n_unmatched / max(n_rows, 1)
        out["traj_differ"] = float(np.mean(~traj)) if len(traj) else 0.0
        out["rows"] = n_rows
        out["rows_big_reference"] = n_big
        return out

    def check(self):
        keys = sorted(self.out)
        ref = self.reference(keys, "float32")
        numbers = self.gaps(self.program_fits(), ref)
        self.records["compare"] = numbers
        return [Check(name, numbers[name], float(limit))
                for name, limit in self.cell["check"]["limits"].items()]
