#!/usr/bin/env python
"""Frame-sharded linking of config 2's fitted rows: port, reference and
the single scan.

    JAX_PLATFORMS=cpu python scripts/sharded_link_parity.py [SHARDS]

Tracks config 2's video (chip_smoke.py::_video: 100 frames of 512², 50
Brownian dimers, noise σ=2) through the port's ``track`` on the CPU with
chip_smoke.py's TRACK_KW, then links the fitted rows three ways: the
port's ``link(mesh=...)`` over SHARDS (default 4) CPU shards, the
reference's ``link(mesh=...)`` over as many virtual CPU devices, and the
single-scan dense auction.  Prints one JSON line: whether the two
sharded links give equal ids, and how many rows lie in trajectories
identical to the single scan's.  The stitch pairs only tracks that end
before a cut with tracks that start after it, so on fitted rows with
gaps it can pair otherwise than the single scan; this shows that the
difference is the reference's design, not the port's.  About 20 s on the
CPU.
"""
import json
import os
import sys
import time

SHARDS = int(sys.argv[1]) if len(sys.argv) > 1 else 4
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_"
                           f"host_platform_device_count={SHARDS}").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    import numpy as np

    import chip_smoke as cs
    import clustertracking_tpu as ct
    import clustertracking_tpu_torch as ctt
    from clustertracking_tpu.parallel.sharding import make_mesh as ref_mesh
    from clustertracking_tpu_torch.parallel.sharding import make_mesh

    t0 = time.perf_counter()
    frames, _ = cs._video()
    out = ctt.track(cs._Stack(frames), device="cpu", **cs.TRACK_KW)
    rows = out[["frame", "y", "x"]].reset_index(drop=True)
    kw = dict(memory=cs.TRACK_KW["memory"])
    sr = cs.TRACK_KW["search_range"]
    port = ctt.link(rows, sr, mesh=make_mesh(["cpu"] * SHARDS), **kw)
    ref = ct.link(rows, sr, mesh=ref_mesh(jax.devices()[:SHARDS]), **kw)
    single = ctt.link(rows, sr, backend="device", device="cpu", **kw)
    p = port["particle"].to_numpy()
    print(json.dumps(dict(
        shards=SHARDS, rows=len(rows),
        port_equals_reference=bool(np.array_equal(
            p, ref["particle"].to_numpy())),
        rows_in_single_scan_trajectories=int(
            cs._rows_in_identical_trajectories(
                p, single["particle"].to_numpy())),
        trajectories_sharded=int(len(np.unique(p))),
        trajectories_single=int(single["particle"].nunique()),
        seconds=round(time.perf_counter() - t0, 1))))


if __name__ == "__main__":
    main()
