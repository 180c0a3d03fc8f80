#!/usr/bin/env python
"""Host time of ``refine_leastsq``'s DataFrame layer, with the fit stubbed.

    python scripts/frame_host_ms.py [--device cpu|cuda] [--calls N]
                                    [--repeats R]

Runs ``refine_leastsq`` on the ``dimer2d`` benchmark configuration's grid
frame (``entry.example_batch``: one 256² frame, one dimer per 16-px cell,
256 dimers, a table of ``frame``, ``y``, ``x`` and ``signal``; the call's
keywords as ``portbench/configs/dimer2d.json`` gives them) with the bucket
solver replaced by a stub that hands back its starting parameters at once,
so what is timed is the host path alone: cluster finding, bucketing, lane
assembly, write-back and the output table.

Prints one JSON line: the median and the quartiles of ms a call over R
repeats of N calls each, and the median ms a call inside each of
``refine_leastsq``'s ranges (``refine.find``, ``refine.prepare``,
``refine.drain``, ``solver.finish``) and outside them.  With
``--device cuda`` the frame stack and lane tensors go to the card and the
results come back, so the uploads and the fetch are in the time; on the
CPU they are not.  It imports only the port.
"""
import argparse
import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SPANS = ("refine.find", "refine.prepare", "refine.drain", "solver.finish")
KW = dict(diameter=9, separation=6.0, max_iter=10, max_shift=1.0,
          lm_max_iter=60, max_rms_dev=1.0)


def _stub_solver(model, ndim, isotropic, n, param_mode_key, *_, **__):
    """A bucket solver that returns its starting parameters, converged."""
    import torch

    from clustertracking_tpu_torch.models.packing import build_layout

    layout = build_layout(model, ndim, isotropic, n, dict(param_mode_key))

    def solve(frames, frame_idx, params0, pose0, valid, fvalid=None):
        B = params0.shape[0]
        dev = params0.device
        return (params0, torch.zeros(B, device=dev),
                torch.ones(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev),
                torch.zeros(0, device=dev))

    return solve, layout


def _table():
    """The grid frame and its feature table, as portbench/drivers/refine.py
    builds them."""
    import numpy as np
    import pandas as pd

    from clustertracking_tpu_torch.entry import example_batch

    image, _, params0, _, _ = example_batch(B=256, frame_size=256)
    start = params0.reshape(-1, 5).astype(float)
    return image[0], pd.DataFrame({
        "frame": np.zeros(len(start), np.int64), "y": start[:, 2],
        "x": start[:, 3], "signal": start[:, 1]})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    import torch

    from clustertracking_tpu_torch import diagnostics, refine

    torch.set_num_threads(1)
    refine._bucket_solver = _stub_solver
    spent = dict.fromkeys(SPANS, 0.0)
    real_stage = diagnostics.stage

    @contextlib.contextmanager
    def timed_stage(name, args=None):
        t0 = time.perf_counter()
        with real_stage(name, args):
            yield
        spent[name] += time.perf_counter() - t0

    diagnostics.stage = timed_stage
    frame, table = _table()
    kw = dict(KW, device=args.device)
    refine.refine_leastsq(table, frame, **kw)             # warm
    sync = (torch.cuda.synchronize if args.device.startswith("cuda")
            else (lambda: None))
    per_call, per_span = [], {s: [] for s in SPANS + ("outside",)}
    for _ in range(args.repeats):
        for s in SPANS:
            spent[s] = 0.0
        sync()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            refine.refine_leastsq(table, frame, **kw)
        sync()
        total = (time.perf_counter() - t0) * 1e3 / args.calls
        per_call.append(total)
        for s in SPANS:
            per_span[s].append(spent[s] * 1e3 / args.calls)
        per_span["outside"].append(
            total - sum(spent[s] for s in SPANS) * 1e3 / args.calls)
    q1, _, q3 = statistics.quantiles(per_call, n=4)
    print(json.dumps(dict(
        device=args.device, rows=len(table),
        calls=args.calls, repeats=args.repeats,
        ms_per_call=dict(median=statistics.median(per_call), q1=q1, q3=q3,
                         all=per_call),
        ms_by_span={s: statistics.median(v) for s, v in per_span.items()})))


if __name__ == "__main__":
    main()
