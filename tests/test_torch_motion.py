"""``motion`` in the port is a copy of the reference's: every case of
tests/test_motion.py goes through both on the same inputs, and the
outputs are equal bit for bit (DataFrames exactly, dicts of floats by
value, NaN equal to NaN), with ``motion._SAME_MEMBERS = False``.  The port
repairs one fault of it, which that switch reproduces: a cluster
trajectory continues only while its member set stays the same (a dimer
that find_clusters merges with a neighbour, or whose member is relinked,
starts a new trajectory), held by the tests after the copy's.
"""
import numpy as np
import pandas as pd
import pytest

from clustertracking_tpu_torch import motion


def _ref():
    from clustertracking_tpu import motion as ref_motion

    return ref_motion


@pytest.fixture
def reference_trajectories():
    """Trajectories continued by majority member overlap, as the
    reference continues them."""
    keep, motion._SAME_MEMBERS = motion._SAME_MEMBERS, False
    yield
    motion._SAME_MEMBERS = keep


def _brownian_dimer(D_trans=0.05, D_rot=0.02, T=400, sep=5.0, seed=0):
    rng = np.random.default_rng(seed)
    center = np.array([50.0, 50.0])
    theta = 0.3
    rows = []
    for t in range(T):
        u = np.array([np.sin(theta), np.cos(theta)])
        for i, s in enumerate((+1, -1)):
            p = center + s * (sep / 2) * u
            rows.append({"frame": t, "y": p[0], "x": p[1], "cluster": 0,
                         "particle": i})
        center = center + rng.normal(0, np.sqrt(2 * D_trans), 2)
        theta = theta + rng.normal(0, np.sqrt(2 * D_rot))
    return pd.DataFrame(rows)


def _brownian_dimer_3d(D_trans=0.05, D_rot=0.01, T=600, sep=5.0, seed=2):
    rng = np.random.default_rng(seed)
    center = np.array([40.0, 40.0, 40.0])
    u = np.array([0.0, 0.0, 1.0])
    rows = []
    for t in range(T):
        for i, s in enumerate((+1, -1)):
            p = center + s * (sep / 2) * u
            rows.append({"frame": t, "z": p[0], "y": p[1], "x": p[2],
                         "cluster": 0, "particle": i})
        center = center + rng.normal(0, np.sqrt(2 * D_trans), 3)
        w = rng.normal(0, np.sqrt(2 * D_rot), 3)
        w = w - (w @ u) * u
        angle = np.linalg.norm(w)
        if angle > 1e-12:
            axis = w / angle
            u = u * np.cos(angle) + np.cross(axis, u) * np.sin(angle)
            u = u / np.linalg.norm(u)
    return pd.DataFrame(rows)


def _axial_rod():
    rows = []
    u = np.array([0.0, 0.6, 0.8])
    center = np.array([20.0, 20.0, 20.0])
    for t in range(5):
        for i, s in enumerate((+1, -1)):
            p = center + s * 2.5 * u
            rows.append({"frame": t, "z": p[0], "y": p[1], "x": p[2],
                         "cluster": 0, "particle": i})
        center = center + 0.7 * u
    return pd.DataFrame(rows)


def _relinked_dimer():
    rows = []
    for t in range(8):
        pid_b = 1 if t < 4 else 7
        for pid, off in [(0, -2.0), (pid_b, 2.0)]:
            rows.append({"frame": t, "y": 20.0 + 0.1 * t, "x": 30.0 + off,
                         "particle": pid, "cluster": 0, "cluster_size": 2})
    return pd.DataFrame(rows)


def _two_clusters():
    rows = []
    for t in range(4):
        for cid, (pids, x0) in enumerate([((0, 1), 20.0), ((2, 3), 60.0)]):
            for k, pid in enumerate(pids):
                rows.append({"frame": t, "y": 30.0, "x": x0 + 4.0 * k,
                             "particle": pid, "cluster": cid,
                             "cluster_size": 2})
    return pd.DataFrame(rows)


def _traj(m, f, **kw):
    return m.cluster_trajectories(f, **kw)


# name -> fn(motion module) -> output: the calls of tests/test_motion.py
CASES = {
    "cluster_trajectories_structure":
        lambda m: _traj(m, _brownian_dimer(T=10)),
    "orientation_angle": lambda m: _traj(m, pd.DataFrame(
        {"frame": [0, 0], "y": [10.0, 10.0], "x": [12.0, 8.0],
         "cluster": [0, 0], "particle": [0, 1]})),
    "orientation": lambda m: m.orientation(
        np.array([[1.0, 2.0], [3.5, -1.0], [0.2, 0.7]])),
    "recover_diffusion_constants": lambda m: m.diffusion_constants(
        _brownian_dimer(0.05, 0.02, T=600), max_lagtime=4),
    "body_frame_displacements": lambda m: m.body_frame_displacements(
        _traj(m, _brownian_dimer(T=50))),
    "msd_linear_in_lag": lambda m: m.msd(
        _traj(m, _brownian_dimer(D_trans=0.05, D_rot=0.0, T=800)),
        ["y", "x"], max_lagtime=5),
    "recover_diffusion_constants_3d": lambda m: m.diffusion_constants(
        _brownian_dimer_3d(0.05, 0.01, T=800), max_lagtime=4),
    "cluster_trajectories_3d_orientation_columns":
        lambda m: _traj(m, _brownian_dimer_3d(T=5)),
    "diffusion_uncertainties_cover_truth": lambda m: [
        m.diffusion_constants(_brownian_dimer(0.05, 0.02, T=500, seed=s),
                              max_lagtime=4) for s in range(6)],
    "body_frame_displacements_3d": lambda m: m.body_frame_displacements(
        _traj(m, _brownian_dimer_3d(T=60, seed=5))),
    "body_frame_pure_axial_translation_3d":
        lambda m: m.body_frame_displacements(_traj(m, _axial_rod())),
    "cluster_trajectories_tolerates_member_relink": lambda m: m.msd(
        _traj(m, _relinked_dimer(), pos_columns=["y", "x"]), ["y", "x"],
        max_lagtime=7),
    "cluster_trajectories_distinct_clusters_stay_distinct":
        lambda m: _traj(m, _two_clusters(), pos_columns=["y", "x"]),
}


def _assert_same(a, b):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_motion_copy(case, reference_trajectories):
    _assert_same(CASES[case](motion), CASES[case](_ref()))


def _merging_dimers(T=12, merged=range(4, 6)):
    """Two dimers 20 px apart, each turning 0.1 rad a frame; over the
    ``merged`` frames find_clusters would see them as one cluster of 4."""
    rows = []
    for t in range(T):
        for k, (pids, x0) in enumerate([((0, 1), 20.0), ((2, 3), 40.0)]):
            th = 0.1 * t * (1 if k == 0 else -1)
            for i, s in enumerate((1, -1)):
                rows.append({
                    "frame": t, "y": 30.0 + s * 2.5 * np.sin(th),
                    "x": x0 + s * 2.5 * np.cos(th), "particle": pids[i],
                    "cluster": 0 if t in merged else k})
    return pd.DataFrame(rows)


def test_trajectories_split_where_members_change():
    """A merge (a cluster of 4 on frames 4 and 5) is a trajectory of its
    own; each dimer takes its own up again after it, within max_gap:
    three trajectories, each of one member set."""
    traj = motion.cluster_trajectories(_merging_dimers(),
                                       pos_columns=["y", "x"])
    members = traj.groupby("cluster_traj")["members"].agg(set)
    assert sorted(len(m) for m in members) == [1, 1, 1]
    assert traj.groupby("cluster_traj").size().sort_values().tolist() == [
        2, 10, 10]


def test_merged_frames_do_not_turn_the_dimers(reference_trajectories):
    """The reference continues a dimer's trajectory through the merge,
    where the orientation is the 4-cluster's; the port's dimers turn by
    their own 0.1 rad a frame."""
    f = _merging_dimers()
    ref_steps = motion.body_frame_displacements(
        motion.cluster_trajectories(f, pos_columns=["y", "x"]))
    motion._SAME_MEMBERS = True
    traj = motion.cluster_trajectories(f, pos_columns=["y", "x"])
    steps = motion.body_frame_displacements(traj[traj["cluster_size"] == 2])
    assert len(steps) == 16
    np.testing.assert_allclose(np.abs(steps["d_angle"]), 0.1, atol=1e-9)
    assert np.abs(ref_steps["d_angle"]).max() > 0.5
