#!/usr/bin/env python
"""How far the dense-scene recovery scoring moves under float32 rounding.

    JAX_PLATFORMS=cpu python scripts/dense_recovery_spread.py [jax|torch] [K]

Scores tests/test_track.py::test_dense_recovery_coverage's scene (one
224×224 frame, 500 features in Brownian dimers, seed 11, drawn by
benchmarks/suite.py::_video) as benchmarks/recovery_exp.py does —
coverage (truth features with an output within 1 px) and ghosts (outputs
more than 1.5 px from every truth) — with 0, 1 and 2 recovery passes, on
the frame and on K copies (default 3) with every pixel moved by one
float32 ulp up or down at random (seeds 101, 102, ...).  The spread over
those copies is the package's own run-to-run spread on this scene: the
chains' capped refits amplify last-bit differences into different gate
decisions.  ``jax`` runs the reference package, ``torch`` the port on the
CPU (with its fix of the reference's rows left moved by an over-cap drop,
and with the reference's behaviour, ``_KEEP_REST_FITS = False``).  One
JSON line per run.
"""
import json
import os
import sys
import time

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KW = dict(diameter=9, separation=6, search_range=3.0, link_backend="host",
          max_features=2048, max_cluster_size=24)


def score(out, tr):
    ot = out[out["cost"].notna()][["y", "x"]].to_numpy()
    d, _ = cKDTree(ot).query(tr, k=1)
    d2, _ = cKDTree(tr).query(ot, k=1)
    return round(float((d < 1.0).mean()), 4), int((d2 > 1.5).sum())


def perturbed(frame, seed):
    rng = np.random.default_rng(seed)
    up = rng.random(frame.shape) < 0.5
    return np.nextafter(frame, np.where(up, np.inf, -np.inf).astype(
        frame.dtype)).astype(frame.dtype)


def main():
    package = sys.argv[1] if len(sys.argv) > 1 else "jax"
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    from benchmarks.suite import _video

    reader, truth = _video(1, 500, (224, 224), 5.0, seed=11)
    tr = truth[["y", "x"]].to_numpy()
    frames = [("frame", reader[0])] + [
        (f"ulp seed {100 + i}", perturbed(reader[0], 100 + i))
        for i in range(1, k + 1)]
    for name, fr in frames:
        t0 = time.perf_counter()
        if package == "jax":
            import clustertracking_tpu as ct

            rec = {p: score(ct.track([fr], recover_passes=p, **KW), tr)
                   for p in (0, 1, 2)}
            print(json.dumps({"package": "jax", "input": name,
                              "coverage_ghosts_by_passes": rec,
                              "s": round(time.perf_counter() - t0, 1)}),
                  flush=True)
            continue
        import torch

        import clustertracking_tpu_torch as ctt
        from clustertracking_tpu_torch import pipeline

        torch.set_num_threads(1)
        for keep in (True, False):
            pipeline._KEEP_REST_FITS = keep
            pipeline._DEBUG_STASH = {}
            try:
                ctt.track([fr], recover_passes=2, device="cpu", **KW)
                passes = pipeline._DEBUG_STASH["passes"]
            finally:
                pipeline._DEBUG_STASH = None
                pipeline._KEEP_REST_FITS = True
            rec = {p: score(passes[min(p, len(passes) - 1)], tr)
                   for p in (0, 1, 2)}
            print(json.dumps({"package": "torch", "input": name,
                              "keep_rest_fits": keep,
                              "coverage_ghosts_by_passes": rec,
                              "s": round(time.perf_counter() - t0, 1)}),
                  flush=True)


if __name__ == "__main__":
    main()
