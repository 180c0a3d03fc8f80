"""The port's ``track`` held to the benchmark's plain tracking reference
``portbench/reference/track_ref.py`` (locate, cluster finding, fit and
Hungarian linking; it imports nothing of the port), on the benchmark's
own video generator ``portbench/gen/brownian_video.py`` (both loaded from
their files), with config 2's keywords at a small size: 8 frames of 128²
with 6 Brownian dimers.  Also the reference's pieces on their own:
``locate`` on isolated features, ``link`` on hand-made scenes, the
reference in TF32, and the generator's seed."""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import clustertracking_tpu_torch as ctt

BENCH = Path(__file__).resolve().parents[1] / "portbench"
CONFIG = dict(diameter=9, separation=6, search_range=3.0, memory=6,
              percentile=64.0, max_features=4096, frames_per_dispatch=32,
              max_iter=10, max_shift=1.0, lm_max_iter=60, ftol=1.49e-8,
              xtol=1.49e-8, max_rms_dev=1.0)
TRACK_KW = dict(diameter=9, separation=6, search_range=3.0, memory=6,
                link_backend="device", device="cpu")
SCENE = dict(dimers=6, bond=5.0, size=1.6, signal=150.0, noise=2.0,
             step=0.5, angle_step=0.1, margin=12.0, clip=10.0)
# Rows pair up within 0.5 px (the fits sit ~1e-4 px apart, features >= 2
# px apart).  The per-row tolerance, 1e-3 px and 1e-3 of the rms, is the
# one the port's kernels are held to against their plain versions and the
# benchmark's cell holds the program to (workloads/video2d.track.json);
# the port's plain route on the CPU and the reference read up to ~3e-4 px
# apart, float32 sums in another order.
MATCH_PX, TOL_PX, TOL_RMS = 0.5, 1e-3, 1e-3


def _bench(name):
    """``portbench/<name>.py``, imported from the benchmark's directory as
    its harness imports it."""
    sys.path.insert(0, str(BENCH))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(BENCH))


@pytest.fixture(scope="module")
def ref():
    return {n: _bench(f"reference.{n}")
            for n in ("track_ref", "locate", "link")}


@pytest.fixture(scope="module")
def brownian_video():
    return _bench("gen.brownian_video")


def _video(brownian_video, seed, frames=8, shape=(128, 128)):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return brownian_video.draw(1, frames, shape, generator=gen,
                               device="cpu", **SCENE)


class _Reader:
    def __init__(self, frames):
        self.frames = frames

    def __getitem__(self, t):
        return self.frames[t]

    def __len__(self):
        return len(self.frames)


def _pairs(a, b):
    """Hungarian pairs of rows of ``a`` and ``b`` [n, 2] within
    ``MATCH_PX``."""
    d2 = ((a[:, None] - b[None]) ** 2).sum(-1)
    far = d2 > MATCH_PX ** 2
    i, j = linear_sum_assignment(np.where(far, 1e6, d2))
    keep = ~far[i, j]
    return i[keep], j[keep]


def _compare(out, r):
    """(rows unmatched, largest position gap, largest relative rms gap,
    matched rows whose trajectories differ) of the port's output against
    the reference's kept rows, both of clusters the reference fits (at
    most 8 features; the port fits larger ones with scipy on the host)."""
    kept = r["kept"] & r["fitted"]
    out = out[out["cluster_size"] <= 8]
    unmatched, pos, rms, pa, pr = 0, [], [], [], []
    for t in np.union1d(out["frame"].unique(), r["frame"][kept]):
        a = out[out["frame"] == t]
        rows = np.flatnonzero(kept & (r["frame"] == t))
        i, j = _pairs(a[["y", "x"]].to_numpy(),
                      np.stack([r["y"][rows], r["x"][rows]], 1))
        unmatched += len(a) + len(rows) - 2 * len(i)
        rj = rows[j]
        pos.append(np.maximum(np.abs(a["y"].to_numpy()[i] - r["y"][rj]),
                              np.abs(a["x"].to_numpy()[i] - r["x"][rj])))
        rms.append(np.abs(a["cost"].to_numpy()[i] - r["cost"][rj])
                   / r["cost"][rj])
        pa.append(a["particle"].to_numpy()[i])
        pr.append(r["particle"][rj])
    pa, pr = np.concatenate(pa), np.concatenate(pr)
    # a trajectory is the set of matched rows that share its particle
    same = [frozenset(np.flatnonzero(pa == pa[k]))
            == frozenset(np.flatnonzero(pr == pr[k])) for k in range(len(pa))]
    return (unmatched, float(np.concatenate(pos).max()),
            float(np.concatenate(rms).max()), int(np.sum(~np.array(same))))


@pytest.mark.parametrize("seed,big", [(2**31 + 7, False), (91, True)])
def test_track_matches_the_reference(ref, brownian_video, seed, big):
    """Every row of ``track(device='cpu')`` pairs with a row of the
    reference's in its frame and none is left on either side; positions
    within 1e-3 px, rms within 1e-3 relative, and the same trajectories.
    Seed 91's video crowds its dimers into clusters of 5 and 6 features
    (the port's bucket of 6, padded)."""
    frames, truth = _video(brownian_video, seed)
    out = ctt.track(_Reader(frames[0]), **TRACK_KW)
    r = ref["track_ref"].track([frames[0]], CONFIG, "cpu")[0]
    assert len(out) == r["kept"].sum() >= 0.9 * truth[0].size // 2
    assert (out["cluster_size"] > 8).sum() == (~r["fitted"]).sum() == 0
    assert (r["cluster_size"] > 4).any() == big
    unmatched, pos, rms, traj = _compare(out, r)
    assert unmatched == 0
    assert pos <= TOL_PX
    assert rms <= TOL_RMS
    assert traj == 0


@pytest.mark.parametrize("jitter,size_tol", [(0.0, 0.005), (2.0, 0.10)],
                         ids=["on_pixels", "sub_pixel"])
@pytest.mark.parametrize("seed", [3, 4])
def test_locate_finds_isolated_features(ref, seed, jitter, size_tol):
    """A noise-free 128² frame of 12 isolated Gaussian features (size 1.6,
    signal 150, 25 px apart): one candidate a feature, on the pixel within
    1 px of it, with the port's own candidates and sizes (``locate`` on the
    CPU, within 1e-5 px: both follow one stated estimator, the reference
    written from its docstring).  Sizes: the truncation correction
    assumes a Gaussian centred on the candidate's pixel, so a feature on a
    pixel reads 1.6 within 0.5%, and one up to 0.5 px off it reads up to
    ~9% low (1.454 at worst on these seeds), within 10%."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(3), indexing="ij"),
                    -1).reshape(-1, 2)
    truth = 20.0 + 25.0 * grid + rng.uniform(-jitter, jitter, grid.shape)
    yy, xx = np.mgrid[0:128, 0:128]
    frame = sum(150.0 * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                               / (2 * 1.6 ** 2)) for y, x in truth)
    frame = frame.astype(np.float32)
    c = ref["locate"].locate(frame, (9.0, 9.0), (3, 3))
    assert len(c["coords"]) == len(truth)
    d = np.sqrt(((c["coords"][:, None] - truth[None]) ** 2).sum(-1))
    assert (d.min(axis=1) <= 1.0).all()
    assert len(set(d.argmin(axis=1))) == len(truth)
    assert np.abs(c["size"] / 1.6 - 1.0).max() <= size_tol
    port = ctt.locate(frame, 9, 3, device="cpu")
    assert np.array_equal(port[["y", "x"]].to_numpy(), c["coords"])
    np.testing.assert_allclose(port["size"].to_numpy(), c["size"],
                               atol=1e-5, rtol=0)


def _frames(*rows):
    return [np.asarray(r, float).reshape(-1, 2) for r in rows]


@pytest.mark.parametrize("scene,expected", [
    # two tracks 2 px apart; the next frame's first feature lies nearer the
    # second track, but the optimum (1.21 + 2.25 against 0.81 + 9 for
    # nearest-first) links each feature to its own track
    (_frames([[10, 10], [10, 12]], [[10, 11.1], [10, 13.5]]),
     [[0, 1], [0, 1]]),
    # a feature missing for `memory` = 2 frames keeps its id ...
    (_frames([[10, 10]], [], [], [[10, 11]]), [[0], [], [], [0]]),
    # ... and one missing for memory + 1 frames starts a new track
    (_frames([[10, 10]], [], [], [], [[10, 11]]), [[0], [], [], [], [1]]),
    # a step of exactly search_range links, one past it does not
    (_frames([[10, 10], [40, 40]], [[13, 10], [40, 43.01]]),
     [[0, 1], [0, 2]]),
], ids=["swap", "memory_gap", "memory_gap_plus_one", "search_range"])
def test_link_on_hand_made_scenes(ref, scene, expected):
    """The reference linker's answers where the objective decides: the
    least total squared displacement, the memory window, the search
    range (search_range 3, memory 2)."""
    ids = ref["link"].link(scene, 3.0, memory=2)
    assert [list(i) for i in ids] == expected


def test_reference_in_tf32_misses_a_tolerance(ref, brownian_video):
    """The control: the reference with TF32 operands in its sums over
    pixels, against itself in float32 on the same video, moves at least
    one row past 1e-3 px or 1e-3 of the rms, where the port stays
    within both (test_track_matches_the_reference)."""
    frames, _ = _video(brownian_video, 2**31 + 7)
    f32, tf32 = (ref["track_ref"].track([frames[0]], CONFIG, "cpu",
                                        precision=p)[0]
                 for p in ("float32", "tf32"))
    assert (f32["kept"] == tf32["kept"]).all()
    pos = np.maximum(np.abs(f32["y"] - tf32["y"]),
                     np.abs(f32["x"] - tf32["x"]))
    rms = np.abs(f32["cost"] - tf32["cost"]) / f32["cost"]
    assert (pos > TOL_PX).any() or (rms > TOL_RMS).any()


def test_generator_is_deterministic_in_its_seed(brownian_video):
    """The same seed draws the same frames and positions bit for bit;
    another seed draws others.  Every feature stays in the frame."""
    a, ta = _video(brownian_video, 2**32 + 5, frames=3, shape=(64, 64))
    b, tb = _video(brownian_video, 2**32 + 5, frames=3, shape=(64, 64))
    c, _ = _video(brownian_video, 2**32 + 6, frames=3, shape=(64, 64))
    assert a.dtype == np.float32 and a.shape == (1, 3, 64, 64)
    assert np.array_equal(a, b) and np.array_equal(ta, tb)
    assert not np.array_equal(a, c)
    assert ta.shape == (1, 3, 12, 2)
    assert (ta >= 10.0 - 2.5).all() and (ta <= 64 - 10.0 + 2.5).all()
