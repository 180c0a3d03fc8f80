"""Config 2's video through ``track`` and ``motion.diffusion_constants`` in
the port and the JAX package: the first 20 frames of
benchmarks/suite.py::_video(100, 100, (512, 512), 5.0) (Brownian dimers,
bond 5 px, size 1.6, noise σ=2, centre steps σ 0.5 px per axis, angle
steps σ 0.1 rad: D_trans 0.125 px²/frame, D_rot 0.005 rad²/frame drawn)
with suite.py::config2's arguments, the port on the CPU.

With the reference's trajectories (``motion._SAME_MEMBERS = False``) the
two packages' tracks agree (the same rows, positions within 1e-3 px,
costs within 1e-4 relative) and so do their diffusion constants (1e-5
relative; 1.7e-6 measured on this cut), and both read D_rot 0.0142 ±
0.0104 against the drawn 0.005 (the truth rows, linked by construction,
give 0.00497).  The excess comes from ``motion.cluster_trajectories``:
where two dimers come within the separation, find_clusters joins them
into one cluster of 3 or 4 for a few frames, and the reference continues
a dimer's trajectory through that cluster (it keeps at least half the
members), whose centre and orientation (centre → lowest particle id) are
not the dimer's.  Two trajectories of this cut hold every lag-1 turn
above 0.5 rad.  The port continues a trajectory only while its member set
stays the same, and reads the drawn constants within their block errors.
"""
import sys

import numpy as np
import pytest
import torch

import clustertracking_tpu_torch as ctt

torch.set_num_threads(1)

KW = dict(diameter=9, separation=6, search_range=3.0, memory=6,
          link_backend="device")
D_RTOL = 1e-5


@pytest.fixture(scope="module")
def video():
    sys.path.insert(0, ".")
    from benchmarks.suite import _video

    reader, truth = _video(20, 100, (512, 512), 5.0)
    # the truth linked by construction: rows come in dimers, 2k and 2k+1
    per_frame = truth.groupby("frame").cumcount().to_numpy()
    truth = truth.assign(particle=per_frame, cluster=per_frame // 2)
    return reader, truth


@pytest.fixture(scope="module")
def tracks(video):
    reader, _ = video
    return ctt.track(reader, device="cpu", **KW)


@pytest.fixture
def reference_trajectories():
    keep, ctt.motion._SAME_MEMBERS = ctt.motion._SAME_MEMBERS, False
    yield
    ctt.motion._SAME_MEMBERS = keep


def test_diffusion_constants_match_reference(video, tracks,
                                             reference_trajectories):
    import clustertracking_tpu as ct

    reader, truth = video
    ref = ct.track(reader, **KW)
    out = tracks
    assert len(out) == len(ref)
    np.testing.assert_array_equal(out["frame"].to_numpy(),
                                  ref["frame"].to_numpy())
    # noisy 512² frames: ~1% of the fits converge (ftol) at the same cost
    # up to 3.4e-4 px apart in the two frameworks, so positions are held
    # at 1e-3 px (chip_smoke.py's TRACK_POS_ATOL) and costs at 1e-4
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               ref[["y", "x"]].to_numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["cost"].to_numpy(),
                               ref["cost"].to_numpy(), rtol=1e-4)
    d_out = ctt.motion.diffusion_constants(out)
    d_ref = ct.motion.diffusion_constants(ref)
    for k in ("D_trans", "D_rot", "D_trans_std", "D_rot_std"):
        np.testing.assert_allclose(d_out[k], d_ref[k], rtol=D_RTOL)
    assert d_out["n_steps"] == d_ref["n_steps"]
    d_truth = ctt.motion.diffusion_constants(truth)
    assert abs(d_truth["D_rot"] - 0.005) <= 3 * d_truth["D_rot_std"]
    assert abs(d_truth["D_trans"] - 0.125) <= 3 * d_truth["D_trans_std"]
    # the excess is the tracks' in both packages
    assert d_out["D_rot"] > 2 * d_truth["D_rot"]


def test_trajectories_through_merged_clusters_make_the_excess(
        tracks, reference_trajectories):
    """Every lag-1 turn above 0.5 rad of the reference's trajectories lies
    on a trajectory whose member set changes size: a dimer continued
    through a cluster that joins it with a neighbour."""
    traj = ctt.motion.cluster_trajectories(tracks)
    steps = ctt.motion.body_frame_displacements(traj)
    jumps = set(steps.loc[steps["d_angle"].abs() > 0.5, "cluster_traj"])
    assert jumps
    sizes = traj.groupby("cluster_traj")["cluster_size"].nunique()
    assert (sizes[sorted(jumps)] > 1).all()


def test_same_member_trajectories_read_the_drawn_constants(tracks):
    """The port's trajectories (one member set each): D_rot within its
    block error of the drawn 0.005, D_trans of the drawn 0.125."""
    d = ctt.motion.diffusion_constants(tracks)
    assert abs(d["D_rot"] - 0.005) <= d["D_rot_std"], d
    assert abs(d["D_trans"] - 0.125) <= d["D_trans_std"], d
