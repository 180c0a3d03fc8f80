"""Driver ``refine``: ``refine_leastsq`` on one host frame a call.

Set-up draws a pool of frames of the configuration's grid scene from the
seed on the card, copies them to the host as a camera or a reader hands
them, and builds each frame's feature table (its dimers' starting
positions and signal).  The window calls
``refine_leastsq(table, frame, diameter, separation)`` on the pool's
frames in turn, one caller, each call timed until its DataFrame is
returned.  After the window the last output of every frame the window
fitted is held to ``reference/frame_fit.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from core import Check
from gen import dimer_grid
from reference import clusters, compare, frame_fit
from roofline import lm_ops

KERNEL = "fused_lm_2d_kernel"
# the traffic entries that shrink this driver's cells to the host
HOST_TRAFFIC = {"frames": 2}
ALTER_PX = 0.01   # one answer moved by a hundredth of a pixel


def make(cell, config, seed, device):
    return Refine(cell, config, seed, device)


def plant(driver, fault):
    """Wrap the driver's ``refine_leastsq`` so that each call suffers
    ``fault`` (``"unchanged"``, ``"half"`` or ``"altered"``)."""
    driver.refine = broken_refine(driver.refine, fault)


def broken_refine(refine, fault):
    def call(table, frame, **kw):
        if fault == "half":
            half = table.iloc[: len(table) // 2]
            out = table.copy()
            out["cost"] = float("nan")
            out["fit_converged"] = False
            out["cluster"] = range(len(out))
            done = refine(half, frame, **kw)
            out.loc[done.index, done.columns] = done
            return out
        out = refine(table, frame, **kw)
        if fault == "unchanged":
            out[["y", "x"]] = table[["y", "x"]].to_numpy()
        else:
            out.loc[out.index[0], "x"] += ALTER_PX
        return out
    return call


class Refine:
    def __init__(self, cell, config, seed, device):
        import pandas as pd

        from clustertracking_tpu_torch import diagnostics, refine_leastsq

        self.cell, self.config, self.device = cell, config, device
        mix = cell["mix"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        frames, _, params0, _ = dimer_grid.draw(
            mix["frames"], config["frame_size"], config["grid_pitch"],
            generator=gen, device=device, size=config["size"],
            separation=config["dimer_separation"], signal=config["signal"])
        self.frames_dev = frames
        host = frames.cpu().numpy()
        self.images = [host[t] for t in range(len(host))]
        per = params0.shape[0] // len(host)
        start = params0.reshape(len(host), per * 2, 5).cpu().numpy()
        self.tables = [
            pd.DataFrame({"frame": np.full(per * 2, t, np.int64),
                          "y": start[t, :, 2].astype(float),
                          "x": start[t, :, 3].astype(float),
                          "signal": start[t, :, 1].astype(float)})
            for t in range(len(host))]
        self.refine = refine_leastsq
        self.kw = dict(diameter=config["diameter"],
                       separation=config["separation"],
                       max_iter=config["max_iter"],
                       max_shift=config["max_shift"],
                       lm_max_iter=config["lm_max_iter"],
                       max_rms_dev=config["max_rms_dev"], device=device)
        self.refine(self.tables[0], self.images[0], **self.kw)  # build, warm
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.last = {}
        self.calls_of = np.zeros(len(self.images), np.int64)
        self.records = {}
        self._collect = diagnostics.collect()
        self.stats = self._collect.__enter__()

    def call(self, i):
        k = i % len(self.images)
        with torch.profiler.record_function("portbench.refine"):
            self.last[k] = self.refine(self.tables[k], self.images[k],
                                       **self.kw)
        self.calls_of[k] += 1
        return {"table": k}

    def close(self):
        """Stop collecting; the program's mean LM iterations a cluster."""
        self._collect.__exit__(None, None, None)
        self.out = self.last
        self.last = {}
        recs = self.stats.batches
        n = sum(r.n_clusters for r in recs)
        self.records["lm_iters"] = (
            sum(r.mean_lm_iters * r.n_clusters for r in recs) / n
            if n else None)

    def reference(self, keys, precision):
        tabs = [{c: self.tables[k][c].to_numpy() for c in ("y", "x",
                                                           "signal")}
                for k in keys]
        frames = self.frames_dev[torch.as_tensor(keys,
                                                 device=self.device)]
        res = frame_fit.fit_frames(frames, tabs, self.config, precision)
        return dict(zip(keys, res))

    def program_fits(self):
        return {k: dict(y=o["y"].to_numpy(), x=o["x"].to_numpy(),
                        cost=o["cost"].to_numpy(),
                        converged=o["fit_converged"].to_numpy(bool),
                        cluster=clusters.canonical(o["cluster"].to_numpy()))
                for k, o in self.out.items()}

    def as_fits(self, ref):
        return {k: dict(y=r["y"], x=r["x"], cost=r["cost"],
                        converged=r["converged"], cluster=r["cluster"])
                for k, r in ref.items()}

    def gaps(self, fits, ref):
        """compare.summary over rows fitted on both sides, and the share
        of rows whose grouping or acceptance differs."""
        pos, rms, conv, group, accept = [], [], [], [], []
        for k in sorted(fits):
            a, r = fits[k], ref[k]
            both = np.isfinite(a["cost"]) & np.isfinite(r["cost"])
            pos.append(np.maximum(np.abs(a["y"] - r["y"]),
                                  np.abs(a["x"] - r["x"]))[both])
            rms.append((np.abs(a["cost"] - r["cost"])
                        / np.abs(r["cost"]))[both])
            conv.append(a["converged"] != r["converged"])
            group.append(a["cluster"] != r["cluster"])
            accept.append(np.isfinite(a["cost"]) != np.isfinite(r["cost"]))
        chk = self.cell["check"]
        out = compare.summary(np.concatenate(pos), np.concatenate(rms),
                              np.concatenate(conv), tol_px=chk["tol_px"],
                              tol_rms=chk["tol_rms"])
        out["grouping_differ"] = float(np.mean(np.concatenate(group)))
        out["accepted_differ"] = float(np.mean(np.concatenate(accept)))
        return out

    def check(self):
        keys = sorted(self.out)
        ref = self.reference(keys, "float32")
        numbers = self.gaps(self.program_fits(), ref)
        self.records["compare"] = numbers
        self._work(ref)
        return [Check(name, numbers[name], float(limit))
                for name, limit in self.cell["check"]["limits"].items()]

    def _work(self, ref):
        """The fused solves' work of the window's calls, from the
        reference's rounds of each frame."""
        ops = nbytes = 0.0
        for k, r in ref.items():
            for n, b in r["rounds"].items():
                V = 3 * n
                w_ops, w_bytes = lm_ops.fit_work(
                    b["rounds"], n=n, D=2, V=V,
                    window_pixels=int(np.prod(b["window"])),
                    lane_bytes=lm_ops.lane_bytes(n, 5, 2, V))
                ops += self.calls_of[k] * w_ops
                nbytes += self.calls_of[k] * w_bytes
        self.records["work"] = {KERNEL: (ops, nbytes)}
        self.records["lm_ops"] = ops
