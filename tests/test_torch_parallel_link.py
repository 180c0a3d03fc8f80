"""Frame-sharded linking in the port (``parallel/linking.py``,
``link(mesh=...)``), held to the JAX package on the same numpy inputs.

The port's mesh is ``make_mesh(["cpu"] * 4)``; the JAX one is
``make_mesh(jax.devices()[:4])`` on the conftest's virtual CPU devices.
Every scene of tests/test_link_sharded.py goes through both packages'
``link_sharded``: the ids must be EQUAL, not only the partitions (both
number trajectories 0, 1, ... in order of first appearance), and the
partition must be the single-scan auction's where the reference's test
says so.  ``link(mesh=...)`` is held to the reference's as a whole
DataFrame, with its backend routing and refusals.  The card test holds
the shards on CUDA to the same call on the CPU.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch.ops.link import link_on_device
from clustertracking_tpu_torch.parallel.linking import (
    _heads_tails, link_sharded)
from clustertracking_tpu_torch.parallel.sharding import make_mesh

torch.set_num_threads(1)

CPU4 = ["cpu"] * 4


def _jax_mesh():
    import jax

    from clustertracking_tpu.parallel.sharding import make_mesh as jmake

    return jmake(jax.devices()[:4])


def _ref_link_sharded(*args, **kw):
    from clustertracking_tpu.parallel.linking import link_sharded as ref

    return np.asarray(ref(*args, **kw))


def _trajectories(T=16, N=10, seed=4, step=0.4):
    rng = np.random.default_rng(seed)
    pos = np.zeros((T, N, 2), np.float32)
    pos[0] = rng.uniform(10, 90, (N, 2))
    for t in range(1, T):
        pos[t] = pos[t - 1] + rng.normal(0, step, (N, 2))
    return pos, np.ones((T, N), bool)


def _gap_at_cut():
    pos, valid = _trajectories(T=16, N=6)
    valid[7, 0] = valid[8, 0] = False     # the 4-shard cut is at 8
    return pos, valid, 3.0, 2, 4


def _spans_two_cuts():
    pos, valid = _trajectories(T=12, N=5, step=0.2)
    valid[3:7, 0] = False                 # shard 1 swallowed whole
    return pos, valid, 3.0, 4, 4


def _two_cut_gap_not_overmerged():
    pos, valid = _trajectories(T=12, N=5, step=0.2)
    valid[3:, 1] = False                  # dies for good
    valid[3:7, 0] = False
    return pos, valid, 3.0, 4, 4


def _contended_crossing():
    T = 8
    pos = np.full((T, 2, 2), 50.0, np.float32)
    xa = [0.0, 0.0, 0.0, 0.0, 0.55, 0.55, 0.55, 0.55]
    xb = [1.0, 1.0, 1.0, 1.0, 1.80, 1.80, 1.80, 1.80]
    for t in range(T):
        pos[t, 0] = (50.0, 20.0 + xa[t])
        pos[t, 1] = (50.0, 20.0 + xb[t])
    return pos, np.ones((T, 2), bool), 1.0, 0, 2


def _crowded(T=12, N=40, seed=9):
    """Walkers packed closer than the search range: subnets of several
    heads and tails at every cut, and tracks ending and starting there."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((T, N, 2), np.float32)
    pos[0] = rng.uniform(0, 30, (N, 2))
    for t in range(1, T):
        pos[t] = pos[t - 1] + rng.normal(0, 0.8, (N, 2))
    valid = rng.uniform(size=(T, N)) > 0.15
    return pos, valid, 2.5, 1, 6


SCENES = {
    "even": lambda: _trajectories() + (3.0, 0, 4),
    "uneven": lambda: _trajectories(T=13) + (3.0, 0, 4),
    "gap_at_cut": _gap_at_cut,
    "spans_two_cuts": _spans_two_cuts,
    "two_cut_gap_not_overmerged": _two_cut_gap_not_overmerged,
    "contended_crossing": _contended_crossing,
    "crowded": _crowded,
}


def _single_partition_equal(pos, valid, sr, memory, ids):
    single = link_on_device(torch.as_tensor(pos), torch.as_tensor(valid),
                            sr, memory).numpy()
    a, b = single[valid], ids[valid]
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_link_sharded_ids_equal_jax(scene):
    pos, valid, sr, memory, S = SCENES[scene]()
    got = link_sharded(pos, valid, sr, memory, n_shards=S, device="cpu")
    want = _ref_link_sharded(pos, valid, sr, memory, n_shards=S)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if scene != "crowded":   # the reference's tests: the single scan's
        assert _single_partition_equal(pos, valid, sr, memory, got)
    if scene == "gap_at_cut":
        assert got[6, 0] == got[9, 0]
    if scene == "spans_two_cuts":
        assert got[2, 0] == got[7, 0]
    if scene == "contended_crossing":
        assert len(np.unique(got[got >= 0])) == 2


def test_link_sharded_on_mesh_equals_jax_mesh():
    pos, valid = _trajectories(T=24)
    got = link_sharded(pos, valid, 3.0, 0, mesh=make_mesh(CPU4))
    want = _ref_link_sharded(pos, valid, 3.0, 0, mesh=_jax_mesh())
    np.testing.assert_array_equal(got, want)
    assert link_sharded.last_stats["shards"] == 4


def test_link_sharded_dense_routes_to_binned():
    """K > 2048 takes the binned auction in every shard ('auto'), with the
    whole video's bounds: ids equal the reference's (two shards of one
    frame; the reference's binned scan at this K takes ~20 s on the CPU)
    and the partition the port's single binned scan's."""
    from clustertracking_tpu_torch.ops.link import link_on_device_binned

    rng = np.random.default_rng(7)
    T, N = 2, 2049
    gx, gy = np.meshgrid(np.arange(46), np.arange(46))
    start = np.stack([gy.ravel() * 10.0 + 5.0, gx.ravel() * 10.0 + 5.0],
                     axis=-1).astype(np.float32)[:N]
    pos = np.stack([start, start + rng.normal(0, 0.3, (N, 2)).astype(
        np.float32)])
    valid = np.ones((T, N), bool)
    got = link_sharded(pos, valid, 3.0, 0, n_shards=2, device="cpu")
    want = _ref_link_sharded(pos, valid, 3.0, 0, n_shards=2)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == N
    single = link_on_device_binned(
        torch.as_tensor(pos), torch.as_tensor(valid), 3.0, 0,
        bounds=((0.0, 512.0), (0.0, 512.0))).numpy()
    assert len(set(zip(single.ravel().tolist(), got.ravel().tolist()))) == N


def test_heads_tails():
    parts = np.array([[0, 1, -1], [0, 2, 1], [3, 2, -1]])
    pos = np.arange(18, dtype=np.float32).reshape(3, 3, 2)
    valid = parts >= 0
    (h_ids, h_t, h_pos), (t_ids, t_t, t_pos) = _heads_tails(
        parts, pos, valid, 1)
    np.testing.assert_array_equal(h_ids, [0, 1])
    np.testing.assert_array_equal(h_t, [0, 0])
    np.testing.assert_array_equal(h_pos, pos[0, :2])
    np.testing.assert_array_equal(t_ids, [2, 3])      # first seen 2, then 3
    np.testing.assert_array_equal(t_t, [2, 2])
    np.testing.assert_array_equal(t_pos, [pos[2, 1], pos[2, 0]])


def _frame_rows(pos, valid=None):
    T, N = pos.shape[:2]
    rows = [{"frame": t, "y": float(pos[t, k, 0]), "x": float(pos[t, k, 1])}
            for t in range(T) for k in range(N)
            if valid is None or valid[t, k]]
    return pd.DataFrame(rows)


@pytest.mark.parametrize("backend", [None, "device", "device-binned"])
def test_link_mesh_equals_jax(backend):
    import clustertracking_tpu as ct

    pos, valid = _trajectories(T=16)
    valid[7, 3] = False
    f = _frame_rows(pos, valid)
    got = ctt.link(f, 3.0, memory=1, mesh=make_mesh(CPU4), backend=backend)
    want = ct.link(f, 3.0, memory=1, mesh=_jax_mesh(), backend=backend)
    pd.testing.assert_frame_equal(got, want)
    assert got.attrs["link_backend"] == want.attrs["link_backend"] == (
        f"sharded:{backend or 'device'}")


def test_link_mesh_rows_with_gaps_pair_as_the_reference():
    """Rows with gaps at the cuts (the crowded walkers, their dropped
    detections left out, memory 2): both packages' ``link(mesh=)`` give
    equal ids, and in both the partition differs from the single scan's.
    The stitch pairs only tracks that end before a cut with tracks that
    start after it, so on such rows it can pair otherwise than the single
    scan: the reference's design, which chip_smoke.py's ``[mesh]`` (e)
    relies on when it holds ``track(mesh=)``'s trajectories to the sharded
    link on the CPU and not to the single scan."""
    import clustertracking_tpu as ct

    pos, valid, sr, _, _ = _crowded()
    f = _frame_rows(pos, valid)
    got = ctt.link(f, sr, memory=2, mesh=make_mesh(CPU4))
    want = ct.link(f, sr, memory=2, mesh=_jax_mesh())
    pd.testing.assert_frame_equal(got, want)
    single = ct.link(f, sr, memory=2, backend="device")
    p, q = want["particle"].tolist(), single["particle"].tolist()
    assert not len(set(zip(p, q))) == len(set(p)) == len(set(q))


def test_link_mesh_refusals():
    f = _frame_rows(*_trajectories(T=8))
    with pytest.raises(ValueError, match="mesh"):
        ctt.link(f, 3.0, mesh=make_mesh(CPU4), backend="host")
    with pytest.raises(TypeError, match="Mesh"):
        ctt.link(f, 3.0, mesh=["cpu"] * 4)
    empty = ctt.link(f.iloc[:0], 3.0, mesh=make_mesh(CPU4))
    assert len(empty) == 0 and "particle" in empty


def test_link_mesh_matches_host_partition():
    """tests/test_sharded_api.py::test_link_mesh_matches_host: six
    walkers, the sharded link's partition equals the host Linker's."""
    rng = np.random.default_rng(11)
    T, N = 16, 6
    pos = np.cumsum(np.concatenate(
        [rng.uniform(10, 90, (1, N, 2)), rng.normal(0, 0.3, (T - 1, N, 2))]),
        axis=0)
    f = _frame_rows(pos)
    out_h = ctt.link(f, 3.0, backend="host")
    out_m = ctt.link(f, 3.0, mesh=make_mesh(CPU4))
    assert out_m["particle"].nunique() == N
    assert len(set(zip(out_h["particle"], out_m["particle"]))) == N


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["gap_at_cut", "crowded"])
def test_link_sharded_on_the_card_matches_cpu(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pos, valid, sr, memory, S = SCENES[scene]()
    on_card = link_sharded(pos, valid, sr, memory,
                           mesh=make_mesh(["cuda:0"] * S))
    on_cpu = link_sharded(pos, valid, sr, memory, n_shards=S, device="cpu")
    np.testing.assert_array_equal(on_card, on_cpu)
