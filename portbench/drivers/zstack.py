"""Driver ``zstack``: the 3D anisotropic bucket solver, back to back.

The window calls the solver that ``refine_leastsq`` dispatches for a
bucket of 3D anisotropic Gaussian dimers in confocal z-stacks, as
``entry.entry_3d(device)`` returns it (its route, gather and ``pixel_lm``
mode left to the port: on CUDA the gathered route, ``window_gather`` then
``pixel_lm`` in the mode occupancy picks), on one bucket of the
configuration's z-stacks; each call starts from its own perturbed table
out of a pool made at set-up.  After the window the last output of each
table is held to ``reference/aniso_fit.py`` on the same stacks and
starts: positions, sizes and rms.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from core import Check
from drivers.solve import broken_solve
from gen import zstack_grid
from reference import aniso_fit
from roofline import gather_bytes, lm_ops

# the traffic entries that shrink this driver's cells to the host
HOST_TRAFFIC = {"stacks": 1, "pool": 2}
N, D, P = 2, 3, 8
V = 7 * N         # signal, three positions and three sizes a feature


def make(cell, config, seed, device):
    return ZStack(cell, config, seed, device)


def plant(driver, fault):
    """Wrap the driver's solver so that each call suffers ``fault``
    (``"unchanged"``, ``"half"`` or ``"altered"``: the bucket solver's
    faults of ``drivers/solve.py``; an altered answer is lane 0's first
    feature moved by 0.01 voxel in y)."""
    driver.solve = broken_solve(driver.solve, fault)


def lane_gaps(fit, ref):
    """Per lane: the largest position gap and the largest size gap (voxels,
    over features and axes) and the absolute rms gap, of ``fit`` (params,
    rms, converged) against the reference's dict."""
    params, rms = fit[0], fit[1]
    B = len(params)
    pos = np.abs(params[:, :, 2:5] - ref["params"][:, :, 2:5])
    size = np.abs(params[:, :, 5:8] - ref["params"][:, :, 5:8])
    return (pos.reshape(B, -1).max(axis=1), size.reshape(B, -1).max(axis=1),
            np.abs(rms - ref["rms"]), fit[2] != ref["converged"])


def summary(pos_gap, size_gap, rms_gap, conv_differ, *, tol_px, tol_size,
            tol_rms):
    """The numbers compared, and their tails for the record.

    ``lanes_off``: the share of lanes with a position gap over ``tol_px``,
    a size gap over ``tol_size`` or an rms gap over ``tol_rms``, or any of
    them not finite.  The rms gap is absolute (in units of the largest
    starting signal, as the rms): the gaps that matter are set by the
    noise, the same in every window, and a noise-free window's rms sits at
    ~1e-7 of the signal, where a gap relative to it measures float32's
    rounding of the cost, not the fit (up to 5.3x)."""
    fin = np.isfinite(pos_gap) & np.isfinite(size_gap) & np.isfinite(rms_gap)
    off = ~fin | (pos_gap > tol_px) | (size_gap > tol_size) | (
        rms_gap > tol_rms)

    def q(a, p):
        a = a[fin]
        return float(np.quantile(a, p)) if len(a) else float("nan")

    def top(a):
        return float(a.max()) if fin.all() else float("inf")

    return {
        "lanes_off": float(np.mean(off)),
        "pos_gap_p999_px": q(pos_gap, 0.999),
        "pos_gap_px": top(pos_gap),
        "pos_gap_median_px": q(pos_gap, 0.5),
        "size_gap_p999_px": q(size_gap, 0.999),
        "size_gap_px": top(size_gap),
        "rms_gap_p999": q(rms_gap, 0.999),
        "rms_gap": top(rms_gap),
        "converged_differ": float(np.mean(conv_differ)),
        "lanes": int(len(pos_gap)),
    }


class ZStack:
    def __init__(self, cell, config, seed, device):
        from clustertracking_tpu_torch.entry import (
            MODES_3D, RADIUS_3D, WINDOW_3D, entry_3d, example_batch_3d)
        from clustertracking_tpu_torch.refine import (
            _launch_counts, _launches_since)

        sizes = {f for f in config["fitted"] if f.startswith("size")}
        if (tuple(config["window"]) != WINDOW_3D
                or tuple(config["radius"]) != RADIUS_3D
                or {name for name, _ in MODES_3D} != sizes):
            raise ValueError("the configuration's window, radius and fitted "
                             "sizes are not those of the port's 3D solver")
        self.cell, self.config, self.device = cell, config, device
        tr = cell["mix"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.stacks, self.sidx, params0, _ = zstack_grid.draw(
            tr["stacks"], config["stack_shape"], config["grid_pitch"],
            generator=gen, device=device, size=tuple(config["size"]),
            separation=config["dimer_separation"], signal=config["signal"],
            center_jitter=config["center_jitter"],
            start_jitter=config["start_jitter"], noise=config["noise"])
        self.pool = zstack_grid.perturbed(params0, tr["pool"], generator=gen,
                                          amount=tr["perturb"])
        B = params0.shape[0]
        self.B = B
        self.pose0 = torch.zeros((B, 0), device=device)
        self.valid = torch.ones(B, dtype=torch.bool, device=device)
        self.solve, _ = entry_3d(device, batch=example_batch_3d(B=1))
        for k in range(min(2, len(self.pool))):   # build, then warm
            self.solve(self.stacks, self.sidx, self.pool[k], self.pose0,
                       self.valid)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.launches_since = _launches_since
        self.counts0 = _launch_counts()
        self.last = {}
        self.calls_of = np.zeros(len(self.pool), np.int64)
        self.records = {}

    def call(self, i):
        k = i % len(self.pool)
        with torch.profiler.record_function("portbench.zstack"):
            self.last[k] = self.solve(self.stacks, self.sidx, self.pool[k],
                                      self.pose0, self.valid)
        self.calls_of[k] += 1
        return {"clusters": self.B}

    def close(self):
        """The window's outputs to the host, the kernels' launches a call
        recorded; the solver's state freed."""
        calls = max(int(self.calls_of.sum()), 1)
        self.records["launches"] = {
            k: v / calls
            for k, v in self.launches_since(self.counts0).items()}
        print(f"portbench: launches a call "
              f"{self.records['launches']}", file=sys.stderr)
        self.out = {k: tuple(t.cpu() for t in o[:4])
                    for k, o in self.last.items()}
        self.last = {}
        self.solve = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, keys, precision):
        """The reference's fit of the tables ``keys``: {k: dict of numpy
        params, rms, converged, iters, rounds}; several tables a batch of
        lanes (they share the stacks)."""
        cfg = self.config
        group = int(self.cell["check"].get("tables_per_batch", 4))
        out = {}
        for g0 in range(0, len(keys), group):
            ks = keys[g0:g0 + group]
            res = aniso_fit.fit(
                self.stacks, self.sidx.repeat(len(ks)),
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
        """``summary`` of ``fits`` ({k: (params, rms, converged)}) against
        the reference ``ref``."""
        valid = self.valid.cpu().numpy()
        parts = [[a[valid] for a in lane_gaps(fits[k], ref[k])]
                 for k in sorted(fits)]
        chk = self.cell["check"]
        return summary(*(np.concatenate(p) for p in zip(*parts)),
                       tol_px=chk["tol_px"], tol_size=chk["tol_size_px"],
                       tol_rms=chk["tol_rms"])

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
        """The work of the window's calls, from the reference's rounds:
        ``pixel_lm``'s LM sweeps and solves, ``window_gather``'s bytes; and
        the program's mean iterations per cluster."""
        npx = int(np.prod(self.config["window"]))
        ops = lm_bytes = g_bytes = 0.0
        iters = lanes = 0.0
        valid = self.valid.cpu().numpy()
        for k, o in self.out.items():
            c = float(self.calls_of[k])
            w_ops, w_bytes = lm_ops.fit_work(
                ref[k]["rounds"], n=N, D=D, V=V, window_pixels=npx,
                lane_bytes=lm_ops.lane_bytes(N, P, D, V), iso=False)
            ops += c * w_ops
            lm_bytes += c * w_bytes
            g_bytes += c * gather_bytes.fit_bytes(
                ref[k]["rounds"], D=D, window_pixels=npx)
            iters += c * float(o[3].numpy()[valid].sum())
            lanes += c * float(valid.sum())
        self.records["work"] = {"pixel_lm_kernel": (ops, lm_bytes),
                                "window_gather_kernel": (0.0, g_bytes)}
        self.records["lm_ops"] = ops
        self.records["lm_iters"] = iters / max(lanes, 1.0)
