"""Driver ``solve``: the bucket solver of the port's main path, back to back.

The window calls the solver that ``refine_leastsq`` dispatches for a
bucket of 2D Gaussian dimers, as ``entry.entry(device)`` returns it, on
one bucket of the configuration's grid scene; each call starts from its
own perturbed table out of a pool made at set-up.  After the window the
last output of each table is held to ``reference/gauss_fit.py`` on the
same frames and starts.
"""
from __future__ import annotations

import numpy as np
import torch

from core import Check
from gen import dimer_grid
from reference import compare, gauss_fit
from roofline import lm_ops

KERNEL = "fused_lm_2d_kernel"
# the traffic entries that shrink this driver's cells to the host
HOST_TRAFFIC = {"frames": 1, "pool": 2}
ALTER_PX = 0.01   # one answer moved by a hundredth of a pixel


def make(cell, config, seed, device):
    return Solve(cell, config, seed, device)


def plant(driver, fault):
    """Wrap the driver's solver so that each call suffers ``fault``
    (``"unchanged"``, ``"half"`` or ``"altered"``)."""
    driver.solve = broken_solve(driver.solve, fault)


def broken_solve(solve, fault):
    def call(frames, fidx, params0, pose0, valid):
        if fault == "half":
            keep = valid.clone()
            keep[len(keep) // 2:] = False
            return solve(frames, fidx, params0, pose0, keep)
        out = list(solve(frames, fidx, params0, pose0, valid))
        if fault == "unchanged":
            out[0] = params0.clone()
        else:
            out[0] = out[0].clone()
            out[0][0, 0, 3] += ALTER_PX
        return tuple(out)
    return call


class Solve:
    def __init__(self, cell, config, seed, device):
        from clustertracking_tpu_torch.entry import (
            RADIUS, WINDOW, entry, example_batch)

        if (tuple(config["window"]) != WINDOW
                or tuple(config["radius"]) != RADIUS):
            raise ValueError("the configuration's window and radius are "
                             "not those of the port's main-path solver")
        self.cell, self.config, self.device = cell, config, device
        tr = cell["mix"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.frames, self.fidx, params0, _ = dimer_grid.draw(
            tr["frames"], config["frame_size"], config["grid_pitch"],
            generator=gen, device=device, size=config["size"],
            separation=config["dimer_separation"],
            signal=config["signal"])
        self.pool = dimer_grid.perturbed(params0, tr["pool"], generator=gen,
                                         amount=tr["perturb"])
        B = params0.shape[0]
        self.B = B
        self.pose0 = torch.zeros((B, 0), device=device)
        self.valid = torch.ones(B, dtype=torch.bool, device=device)
        self.solve, _ = entry(device, batch=example_batch(B=1))
        for k in range(min(2, len(self.pool))):   # build, then warm
            self.solve(self.frames, self.fidx, self.pool[k], self.pose0,
                       self.valid)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.last = {}
        self.calls_of = np.zeros(len(self.pool), np.int64)
        self.records = {}

    def call(self, i):
        k = i % len(self.pool)
        with torch.profiler.record_function("portbench.solve"):
            self.last[k] = self.solve(self.frames, self.fidx, self.pool[k],
                                      self.pose0, self.valid)
        self.calls_of[k] += 1
        return {"clusters": self.B}

    def close(self):
        """The window's outputs to the host; the solver's state freed."""
        self.out = {k: tuple(t.cpu() for t in o[:4])
                    for k, o in self.last.items()}
        self.last = {}
        self.solve = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, keys, precision):
        """The reference's fit of the tables ``keys``: {k: dict of numpy
        params, rms, converged, iters, rounds}; several tables a batch of
        lanes (they share the frames)."""
        cfg = self.config
        group = int(self.cell["check"].get("tables_per_batch", 8))
        out = {}
        for g0 in range(0, len(keys), group):
            ks = keys[g0:g0 + group]
            res = gauss_fit.fit(
                self.frames, self.fidx.repeat(len(ks)),
                torch.cat([self.pool[k] for k in ks]),
                self.valid.repeat(len(ks)), window=tuple(cfg["window"]),
                radius=tuple(cfg["radius"]), max_iter=cfg["max_iter"],
                max_shift=cfg["max_shift"], lm_max_iter=cfg["lm_max_iter"],
                ftol=cfg["ftol"], xtol=cfg["xtol"], precision=precision)
            for j, k in enumerate(ks):
                sl = slice(j * self.B, (j + 1) * self.B)
                out[k] = dict(
                    params=res["params"][sl].cpu().numpy(),
                    rms=res["rms"][sl].cpu().numpy(),
                    converged=res["converged"][sl].cpu().numpy(),
                    iters=res["iters"][sl].cpu().numpy(),
                    rounds=[{key: v[sl].cpu().numpy() for key, v in r.items()}
                            for r in res["rounds"]])
        return out

    def gaps(self, fits, ref):
        """compare.summary of ``fits`` ({k: (params, rms, converged)})
        against the reference ``ref``."""
        valid = self.valid.cpu().numpy()
        parts = [compare.lane_gaps(fits[k][0][:, :, 2:4], fits[k][1],
                                   fits[k][2], ref[k]["params"][:, :, 2:4],
                                   ref[k]["rms"], ref[k]["converged"], valid)
                 for k in sorted(fits)]
        chk = self.cell["check"]
        return compare.summary(*(np.concatenate(p) for p in zip(*parts)),
                               tol_px=chk["tol_px"], tol_rms=chk["tol_rms"])

    def as_fits(self, ref):
        return {k: (r["params"], r["rms"], r["converged"])
                for k, r in ref.items()}

    def program_fits(self):
        return {k: (o[0].numpy(), o[1].numpy(), o[2].numpy())
                for k, o in self.out.items()}

    def check(self):
        keys = sorted(self.out)
        ref = self.reference(keys, "float32")
        numbers = self.gaps(self.program_fits(), ref)
        self.records["compare"] = numbers
        self._work(ref)
        return [Check(name, numbers[name], float(limit))
                for name, limit in self.cell["check"]["limits"].items()]

    def _work(self, ref):
        """The LM work of the window's calls, from the reference's rounds,
        and the program's mean iterations per cluster."""
        cfg = self.config
        n, D = 2, 2
        V, P = 3 * n, 5
        npx = int(np.prod(cfg["window"]))
        ops = nbytes = 0.0
        iters = lanes = 0.0
        valid = self.valid.cpu().numpy()
        for k, o in self.out.items():
            c = float(self.calls_of[k])
            w_ops, w_bytes = lm_ops.fit_work(
                ref[k]["rounds"], n=n, D=D, V=V, window_pixels=npx,
                lane_bytes=lm_ops.lane_bytes(n, P, D, V))
            ops += c * w_ops
            nbytes += c * w_bytes
            iters += c * float(o[3].numpy()[valid].sum())
            lanes += c * float(valid.sum())
        self.records["work"] = {KERNEL: (ops, nbytes)}
        self.records["lm_ops"] = ops
        self.records["lm_iters"] = iters / max(lanes, 1.0)
