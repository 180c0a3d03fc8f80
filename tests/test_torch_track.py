"""``track`` and the whole workflow in the port, held to the JAX package
on the same numpy inputs, with the port on the CPU.

Scenes: tests/test_track.py's dimer video (``track`` with the device and
the host linker), tests/test_pipeline.py's three cases (refine → link →
motion) and tests/test_checkpoint.py's three (the Linker round trip,
checkpoint and resume, a hard kill, the last as a script that imports
the port only).  What has to agree:

- the same rows in the same order, the same trajectory partition
  (``particle``) and the same ``cluster`` partition as JAX;
- positions within 1e-4 px of JAX (float32 fits on both sides, the
  reference's XLA against the port's torch), and the reference tests' own
  truth tolerances on the port's result;
- the loss ledger's counts and its ``link_backend``;
- a checkpoint that the JAX ``track`` wrote for its first chunk resumes
  in the port to the port's single-shot result.

A ``mesh=`` that is not the port's ``Mesh`` raises ``TypeError``
(``track(mesh=)`` is held in tests/test_torch_parallel_fit.py); the
recovery passes and ``transfer_dtype`` are held in
tests/test_torch_recovery.py.  The card
test holds ``track`` on CUDA to the same call on the CPU.
"""
import functools
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial

torch.set_num_threads(1)

track_cpu = functools.partial(ctt.track, device="cpu")
POS_ATOL = 1e-4


def _ref():
    import clustertracking_tpu as ct

    return ct


def _dimer_video(T=6, shape=(80, 80), seed=0):
    """tests/test_track.py::_dimer_video."""
    rng = np.random.default_rng(seed)
    rows = []
    centers = np.array([[20.0, 20.0], [20.0, 60.0], [60.0, 40.0]])
    angles = np.array([0.3, 1.2, 2.0])
    for t in range(T):
        for k in range(len(centers)):
            u = np.array([np.sin(angles[k]), np.cos(angles[k])])
            for s in (1, -1):
                p = centers[k] + s * 2.5 * u
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 200.0})
        centers += rng.normal(0, 0.3, centers.shape)
        angles += rng.normal(0, 0.05, angles.shape)
    truth = pd.DataFrame(rows)
    return truth, artificial.CoordinateReader(truth, shape, size=2.0)


def _checkpoint_video(n_frames=8, n_clusters=6, seed=11):
    """tests/test_checkpoint.py::_video."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 100, (n_clusters, 2))
    angles = rng.uniform(0, np.pi, n_clusters)
    rows = []
    for t in range(n_frames):
        centers = np.clip(centers + rng.normal(0, 0.4, centers.shape),
                          15, 105)
        angles = angles + rng.normal(0, 0.1, n_clusters)
        offs = 2.5 * np.stack([np.sin(angles), np.cos(angles)], -1)
        for k in range(n_clusters):
            for sgn in (+1, -1):
                p = centers[k] + sgn * offs[k]
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 150.0})
    f = pd.DataFrame(rows)
    return artificial.CoordinateReader(f, (120, 120), size=1.6), f


def _make_video(T=12, n_dimers=3, seed=0, noise=0.0):
    """tests/test_pipeline.py::_make_video."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(15, 80, (n_dimers, 2))
    angles = rng.uniform(0, np.pi, n_dimers)
    rows = []
    for t in range(T):
        for k in range(n_dimers):
            u = np.array([np.sin(angles[k]), np.cos(angles[k])])
            for s in (+1, -1):
                p = centers[k] + s * 2.5 * u
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 200.0, "dimer": k})
        centers += rng.normal(0, 0.4, centers.shape)
        angles += rng.normal(0, 0.1, n_dimers)
    truth = pd.DataFrame(rows)
    reader = artificial.CoordinateReader(truth, (96, 96), size=2.5,
                                         noise_level=noise)
    return truth, reader


def _partition(ids):
    """Ids relabelled in order of first appearance: equal arrays mean the
    same partition of the rows."""
    _, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv]


def _same_tracks(out, ref, pos_atol=POS_ATOL):
    assert list(out.columns) == list(ref.columns)
    assert len(out) == len(ref)
    np.testing.assert_array_equal(out["frame"].to_numpy(),
                                  ref["frame"].to_numpy())
    pos = [c for c in ("z", "y", "x") if c in ref.columns]
    np.testing.assert_allclose(out[pos].to_numpy(), ref[pos].to_numpy(),
                               rtol=0, atol=pos_atol)
    for col in ("particle", "cluster"):
        if col in ref.columns:
            np.testing.assert_array_equal(_partition(out[col].to_numpy()),
                                          _partition(ref[col].to_numpy()))


def _truth_close(out, truth, tol):
    """tests/test_track.py's truth check: every tracked position within
    ``tol`` px of a generating coordinate of its frame."""
    for t in sorted(truth["frame"].unique()):
        got = out[out["frame"] == t][["y", "x"]].to_numpy()
        want = truth[truth["frame"] == t][["y", "x"]].to_numpy()
        d, _ = cKDTree(want).query(got)
        assert d.max() < tol, (t, d.max())


@pytest.mark.parametrize("T,link_backend", [(6, None), (4, "host")])
def test_track_matches_reference(T, link_backend):
    """tests/test_track.py::test_track_end_to_end (the default linker:
    'auto', here the dense auction) and ::test_track_host_link_backend."""
    truth, reader = _dimer_video(T=T)
    kw = dict(diameter=7, separation=6.0, search_range=2.0,
              param_val={"size": 2.0}, threshold=20.0,
              link_backend=link_backend)
    with _ref().diagnostics.collect() as s_ref:
        ref = _ref().track(reader, **kw)
    with ctt.diagnostics.collect() as s_out:
        out = track_cpu(reader, **kw)
    _same_tracks(out, ref)
    assert out["particle"].dtype == ref["particle"].dtype
    assert out.attrs["link_backend"] == ref.attrs["link_backend"]
    walls = ("locate_s", "find_s", "fit_s", "link_s")
    assert ({k: v for k, v in s_out.ledger.items() if k not in walls}
            == {k: v for k, v in s_ref.ledger.items() if k not in walls})
    assert all(s_out.ledger[k] >= 0 for k in walls)
    assert out["particle"].nunique() == 6
    assert (out.groupby("particle").size() == T).all()
    _truth_close(out, truth, 0.01)


@pytest.mark.parametrize("case", ["noiseless", "noise_and_motion",
                                  "three_frame_chunks"])
def test_pipeline_matches_reference(case):
    """tests/test_pipeline.py's three cases: refine_leastsq from perturbed
    truth, then link (and motion.cluster_trajectories), in both
    packages."""
    ct = _ref()
    T, n, seed, noise, pseed = {"noiseless": (12, 3, 0, 0.0, 1),
                                "noise_and_motion": (16, 2, 2, 3.0, 3),
                                "three_frame_chunks": (6, 2, 0, 0.0, 4)}[case]
    truth, reader = _make_video(T=T, n_dimers=n, seed=seed, noise=noise)
    rng = np.random.default_rng(pseed)
    amp = 0.2 if case == "three_frame_chunks" else 0.3
    f0 = truth.drop(columns=["signal"]).copy()
    f0["y"] += rng.uniform(-amp, amp, len(f0))
    f0["x"] += rng.uniform(-amp, amp, len(f0))
    kw = dict(diameter=9, separation=6.0, param_val={"size": 2.5})
    if case == "three_frame_chunks":
        outs = [ctt.refine_leastsq(f0, reader, frames_per_dispatch=k,
                                   device="cpu", **kw) for k in (8, 2)]
        ref = ct.refine_leastsq(f0, reader, frames_per_dispatch=2, **kw)
        np.testing.assert_allclose(outs[0][["y", "x"]].to_numpy(),
                                   outs[1][["y", "x"]].to_numpy(), atol=1e-5)
        _same_tracks(outs[1], ref)
        return
    refined = ctt.refine_leastsq(f0, reader, device="cpu", **kw)
    ref = ct.refine_leastsq(f0, reader, **kw)
    _same_tracks(refined, ref)
    np.testing.assert_array_equal(refined["cost"].notna().to_numpy(),
                                  ref["cost"].notna().to_numpy())
    ok = refined["cost"].notna()
    linked = ctt.link(refined[ok], search_range=2.5)
    linked_ref = ct.link(ref[ok], search_range=2.5)
    _same_tracks(linked, linked_ref)
    err = np.abs(refined.loc[ok, ["y", "x"]].to_numpy()
                 - truth.loc[ok, ["y", "x"]].to_numpy())
    if case == "noiseless":
        assert ok.all() and err.max() < 0.01
        assert (linked.groupby("particle").size() == T).all()
        assert linked["particle"].nunique() == 6
    else:
        assert ok.mean() > 0.9 and np.sqrt((err ** 2).mean()) < 0.1
        traj = ctt.motion.cluster_trajectories(linked)
        pd.testing.assert_frame_equal(
            traj, ct.motion.cluster_trajectories(linked_ref), atol=1e-4)
        assert traj["cluster_size"].eq(2).mean() > 0.9


CKPT = dict(diameter=7, separation=5.5, search_range=3.0)


def _sorted(out):
    return out.sort_values(["frame", "y", "x"]).reset_index(drop=True)


def _same_checkpointed(out, ref, atol=1e-5):
    """tests/test_checkpoint.py's comparison: the same rows, particle ids
    equal, positions within 1e-5 px."""
    out_s, ref_s = _sorted(out), _sorted(ref)
    assert len(out_s) == len(ref_s)
    np.testing.assert_allclose(out_s[["y", "x"]].to_numpy(),
                               ref_s[["y", "x"]].to_numpy(), atol=atol)
    np.testing.assert_array_equal(out_s["particle"].to_numpy(),
                                  ref_s["particle"].to_numpy())


def test_linker_state_roundtrip():
    """tests/test_checkpoint.py::test_linker_state_roundtrip, with the
    state written by the reference's Linker and read by the port's."""
    from clustertracking_tpu.link import Linker as RefLinker

    rng = np.random.default_rng(0)
    lk = RefLinker(3.0, memory=1)
    pos0 = rng.uniform(0, 50, (5, 2))
    lk.advance(0, pos0)
    lk2 = ctt.Linker.from_state(json.loads(json.dumps(lk.state())))
    pos1 = pos0 + rng.normal(0, 0.3, pos0.shape)
    np.testing.assert_array_equal(lk.advance(1, pos1), lk2.advance(1, pos1))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_resume_matches_single_shot(tmp_path, writer):
    """tests/test_checkpoint.py::test_checkpoint_resume_matches_single_shot:
    interrupted after the first 3-frame chunk and resumed, against the
    single-shot host-linked run.  The first chunk is written by the port
    or by the JAX track; the port resumes it either way, and its
    single-shot run matches the reference's.  The rows of a chunk that
    JAX fitted sit within POS_ATOL of the port's fits, not 1e-5."""
    reader, _ = _checkpoint_video()
    ref = track_cpu(reader, link_backend="host", **CKPT)
    ck = tmp_path / "ck"
    first = track_cpu if writer == "port" else _ref().track
    first(reader, checkpoint_dir=str(ck), checkpoint_every=3, n_frames=3,
          **CKPT)
    assert json.loads((ck / "state.json").read_text())["next_frame"] == 3
    out = track_cpu(reader, checkpoint_dir=str(ck), checkpoint_every=3,
                    **CKPT)
    _same_checkpointed(out, ref, atol=1e-5 if writer == "port" else POS_ATOL)
    np.testing.assert_array_equal(
        np.unique(out["cluster"]), np.arange(out["cluster"].nunique()))
    again = track_cpu(reader, checkpoint_dir=str(ck), checkpoint_every=3,
                      **CKPT)
    assert len(again) == len(out)
    if writer == "reference":
        jax_ref = _ref().track(reader, link_backend="host", **CKPT)
        _same_tracks(ref, jax_ref)
        with pytest.raises(ValueError, match="resumable"):
            track_cpu(reader, checkpoint_dir=str(ck), link_backend="device",
                      **CKPT)


_KILL_SCRIPT = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np, pandas as pd, torch
torch.set_num_threads(1)
import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch.artificial import CoordinateReader
assert "jax" not in sys.modules
rng = np.random.default_rng(11)
centers = rng.uniform(20, 100, (6, 2)); angles = rng.uniform(0, np.pi, 6)
rows = []
for t in range(8):
    centers = np.clip(centers + rng.normal(0, 0.4, centers.shape), 15, 105)
    angles = angles + rng.normal(0, 0.1, 6)
    offs = 2.5 * np.stack([np.sin(angles), np.cos(angles)], -1)
    for k in range(6):
        for sgn in (+1, -1):
            p = centers[k] + sgn * offs[k]
            rows.append({{"frame": t, "y": p[0], "x": p[1], "signal": 150.0}})
f = pd.DataFrame(rows)
reader = CoordinateReader(f, (120, 120), size=1.6)
out = ctt.track(reader, diameter=7, separation=5.5, search_range=3.0,
                checkpoint_dir={ck!r}, checkpoint_every=2, device="cpu")
print("DONE", len(out), out["particle"].nunique(), flush=True)
"""


def test_checkpoint_survives_hard_kill(tmp_path):
    """tests/test_checkpoint.py::test_checkpoint_survives_hard_kill as a
    script that imports the port only: SIGKILL once the first checkpoint
    lands, then resume to completion."""
    ck = tmp_path / "ck"
    script = _KILL_SCRIPT.format(repo=os.getcwd(), ck=str(ck))
    p = subprocess.Popen([sys.executable, "-u", "-c", script])
    deadline = time.time() + 120
    state = ck / "state.json"
    while time.time() < deadline:
        if state.exists() or p.poll() is not None:
            break
        time.sleep(0.2)
    if p.poll() is None:
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
        assert state.exists(), "no checkpoint was written before the kill"
    r = subprocess.run([sys.executable, "-u", "-c", script],
                       capture_output=True, text=True, timeout=300)
    assert "DONE" in r.stdout, r.stdout + r.stderr
    n_rows, n_traj = map(int, r.stdout.split("DONE")[1].split())
    assert n_rows == 8 * 12
    assert n_traj == 12


@pytest.mark.parametrize("kw", [{"mesh": object()}])
def test_track_refuses_what_is_not_ported(kw):
    """Everything of ``track`` is ported; what it refuses is a ``mesh``
    that is not the port's ``Mesh`` (``TypeError``).  Recovery passes and
    ``transfer_dtype`` are held to the reference in
    tests/test_torch_recovery.py, ``mesh=`` in
    tests/test_torch_parallel_fit.py."""
    _, reader = _dimer_video(T=2)
    with pytest.raises(TypeError, match="Mesh"):
        track_cpu(reader, diameter=7, **kw)


def test_track_needs_a_device():
    """With no ``device`` track runs on CUDA and, where there is none,
    raises before any stage runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    _, reader = _dimer_video(T=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ctt.track(reader, diameter=7)


@pytest.mark.cuda
def test_track_on_the_card_matches_cpu():
    """tests/test_track.py's scene through track on CUDA against the same
    call on the CPU: the same rows and partitions, positions within
    1e-3 px (the card's fused_lm_2d against its plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, reader = _dimer_video()
    kw = dict(diameter=7, separation=6.0, search_range=2.0,
              param_val={"size": 2.0}, threshold=20.0)
    on_card = ctt.track(reader, device="cuda", **kw)
    _same_tracks(on_card, track_cpu(reader, **kw), pos_atol=1e-3)
    assert on_card.attrs["link_backend"] == "device"
