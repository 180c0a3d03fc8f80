"""``track``'s recovery passes at config 5's density, in the port and the
JAX package: tests/test_track.py::test_dense_recovery_coverage's scene
(one 224×224 frame, 500 features in Brownian dimers, seed 11, drawn by
benchmarks/suite.py::_video), with no pass, one and two, scored as
benchmarks/recovery_exp.py scores it: coverage (truth features with an
output within 1 px) and ghosts (outputs more than 1.5 px from every
truth).

The scene's chains are refitted on a 16-iteration budget, and there the
last bits of the arithmetic decide gates: the reference's own coverage
moves by 1.4 points after one pass and 2.4 points after two when every
pixel of the frame moves by one float32 ulp (0.876–0.890 and
0.912–0.936 over the frame and three such copies,
``scripts/dense_recovery_spread.py jax``).  So the port's coverage is
held within that spread of JAX's (pass 0, where nothing is capped,
within 0.5 points), its ghosts within max(2, 10%), and the port's runs
to the reference test's own gates.

The port fixes the reference's rows left moved and halved by an over-cap
drop (its pipeline.py:802-810; tests/test_torch_recovery.py).  On this
scene that fault moves a row of an absorbed pair from the pair's
midpoint (1.1 px from either member) towards one member, where it counts
as tracked: after two passes the port's coverage is 0.890–0.898 with the
fix and 0.902–0.934 without it (the script's ``torch`` runs).  The
second pass is compared with JAX with the fault reproduced
(``_KEEP_REST_FITS = False``); the fixed runs meet the reference's gates.
The port runs on the CPU; both port runs take ~50 s each here, so the
scene has a file of its own.
"""
import sys

import pytest
import torch
from scipy.spatial import cKDTree

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import pipeline as tp

torch.set_num_threads(1)

# coverage points by passes: pass 0 the stated tolerance, passes 1 and 2
# the reference's own spread (scripts/dense_recovery_spread.py jax)
COVERAGE_POINTS = {0: 0.5, 1: 1.4, 2: 2.4}
KW = dict(diameter=9, separation=6, search_range=3.0, link_backend="host",
          max_features=2048, max_cluster_size=24)


@pytest.fixture(scope="module")
def scene():
    sys.path.insert(0, ".")
    from benchmarks.suite import _video

    reader, truth = _video(1, 500, (224, 224), 5.0, seed=11)
    return reader, truth[truth["frame"] == 0][["y", "x"]].to_numpy()


def _port_passes(reader, keep_rest_fits):
    """The port's fitted rows before the first pass and after each of two
    (one ``track`` call, read through the ``_DEBUG_STASH`` hook)."""
    tp._DEBUG_STASH, tp._KEEP_REST_FITS = {}, keep_rest_fits
    try:
        ctt.track(reader, recover_passes=2, device="cpu", **KW)
        passes = tp._DEBUG_STASH["passes"]
    finally:
        tp._DEBUG_STASH, tp._KEEP_REST_FITS = None, True
    return [passes[min(p, len(passes) - 1)] for p in (0, 1, 2)]


@pytest.fixture(scope="module")
def runs(scene):
    import clustertracking_tpu as ct

    reader, _ = scene
    ref = [ct.track(reader, recover_passes=p, **KW) for p in (0, 1, 2)]
    return ref, _port_passes(reader, True), _port_passes(reader, False)


def _score(out, tr):
    """(coverage, ghosts) as benchmarks/recovery_exp.py scores them."""
    ot = out[out["cost"].notna()][["y", "x"]].to_numpy()
    d, _ = cKDTree(ot).query(tr, k=1)
    d2, _ = cKDTree(tr).query(ot, k=1)
    return float((d < 1.0).mean()), int((d2 > 1.5).sum())


@pytest.mark.parametrize("passes", [0, 1, 2])
def test_dense_coverage_matches_reference(scene, runs, passes):
    _, tr = scene
    ref, fixed, mirrored = runs
    out = (mirrored if passes == 2 else fixed)[passes]
    c_ref, g_ref = _score(ref[passes], tr)
    c_out, g_out = _score(out, tr)
    assert abs(c_out - c_ref) * 100 <= COVERAGE_POINTS[passes], (c_ref,
                                                                 c_out)
    assert abs(g_out - g_ref) <= max(2, 0.1 * g_ref), (g_ref, g_out)


@pytest.mark.parametrize("keep_rest_fits", [True, False])
def test_dense_recovery_gates_hold_on_the_port(scene, runs, keep_rest_fits):
    """tests/test_track.py::test_dense_recovery_coverage's assertions on
    the port's runs, with the fix and without it."""
    _, tr = scene
    out = runs[1] if keep_rest_fits else runs[2]
    (c0, g0), (c1, g1), (c2, g2) = (_score(o, tr) for o in out)
    assert c1 > c0 + 0.05, (c0, c1)
    assert c1 > 0.85, c1
    assert g1 <= max(2 * g0, 15), (g0, g1)
    assert c2 >= c1 - 0.01, (c1, c2)
    assert g2 <= g1 + max(g1 // 2, 5), (g1, g2)
