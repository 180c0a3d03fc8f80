"""Linking in the port (``link.py``, ``ops/link.py``), held to the JAX
package on the same numpy inputs.

Every scene of tests/test_link.py and tests/test_link_device.py, and a
few more (tied bids, a frame past the 'auto' threshold), goes through
``link`` of both packages with each backend: host against host, the
dense auction against the dense auction, the binned against the binned,
the port's auctions on the CPU.  What has to agree, exactly: the whole
output DataFrame (particle ids row for row, their dtype: int64 from the
host linker, int32 from the auctions) and ``attrs['link_backend']``.
The host ``Linker`` is a copy: its ids and its ``state()`` equal the
reference's after every frame, and a state the reference wrote resumes
in the port's.  The card tests hold the auctions on CUDA to the same
call on the CPU, and the dense auction's kernel route
(``csrc/link_auction.cu``) to its torch loop on the same CUDA tensors,
particle for particle; the CPU tests hold the rule that picks the route.
"""
import json

import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch.link import Linker, _pad_frames
from clustertracking_tpu_torch.ops.link import (
    _check_points, _library, _link_kernel, _link_torch, auction_route,
    link_on_device, link_on_device_binned)
from clustertracking_tpu_torch.utils import guess_pos_columns

torch.set_num_threads(1)

BACKENDS = ["host", "device", "device-binned"]


def _ref():
    import clustertracking_tpu as ct

    return ct


def _traj_df(trajs):
    """trajs: list of [(frame, y, x), ...] per particle."""
    return pd.DataFrame([{"frame": t, "y": y, "x": x}
                         for pts in trajs for t, y, x in pts])


def _walkers(rng, n=8, T=12, step=0.3, span=(10, 90)):
    starts = np.stack([np.linspace(span[0], span[1], n)] * 2, axis=-1)
    rows, pos = [], starts.copy()
    for t in range(T):
        pos = pos + rng.normal(0, step, pos.shape)
        rows += [{"frame": t, "y": pos[i, 0], "x": pos[i, 1]}
                 for i in range(n)]
    return pd.DataFrame(rows)


def _random_walkers(rng, n=12, T=20):
    starts = rng.uniform(10, 90, (n, 2))
    starts = starts[np.argsort(starts[:, 0])]
    rows, pos = [], starts.copy()
    for t in range(T):
        pos = pos + rng.normal(0, 0.3, pos.shape)
        rows += [{"frame": t, "y": pos[i, 0], "x": pos[i, 1]}
                 for i in range(n)]
    return pd.DataFrame(rows)


def _crossings(rng, trials, n=14):
    out = []
    for _ in range(trials):
        a = rng.uniform(0, 6, (n, 2))
        b = a + rng.normal(0, 0.5, (n, 2))
        out.append(pd.DataFrame({
            "y": np.concatenate([a[:, 0], b[:, 0]]),
            "x": np.concatenate([a[:, 1], b[:, 1]]),
            "frame": [0] * n + [1] * n,
        }))
    return out


def _memory_gap():
    rows = [{"frame": 0, "y": 10.0, "x": 10.0},
            {"frame": 1, "y": 10.5, "x": 10.0},
            {"frame": 3, "y": 11.5, "x": 10.0}]
    return pd.DataFrame(rows + [{"frame": t, "y": 50.0, "x": 50.0}
                                for t in range(4)])


def _varying_counts():
    rows = []
    for t in range(6):
        rows.append({"frame": t, "y": 20.0 + 0.2 * t, "x": 20.0})
        if t % 2 == 0:
            rows.append({"frame": t, "y": 60.0, "x": 60.0 + 0.2 * t})
    return pd.DataFrame(rows)


def _cell_boundary():
    rows = []
    for t in range(6):
        rows.append({"frame": t, "y": 7.0, "x": 3.0 + 4.9 * t})
        rows.append({"frame": t, "y": 40.0, "x": 60.0 - 4.9 * t})
    return pd.DataFrame(rows)


def _filter_stubs_scene():
    rows = [{"frame": t, "y": 10.0 + 0.1 * t, "x": 10.0} for t in range(12)]
    rows += [{"frame": t, "y": 40.0, "x": 40.0} for t in (3, 4)]
    return pd.DataFrame(rows)


def _tied_bids():
    """Exact ties: two features equidistant from one track (equal bids:
    the lowest feature index wins), one feature equidistant from two
    tracks (the first track), and a square where every feature is
    equally far from every track."""
    return pd.DataFrame({
        "frame": [0, 1, 1, 0, 0, 1, 0, 0, 1, 1],
        "y": [0.0, 0.0, 0.0, 20.0, 20.0, 20.0, 40.0, 42.0, 40.0, 42.0],
        "x": [1.0, 0.0, 2.0, 0.0, 2.0, 1.0, 0.0, 2.0, 2.0, 0.0],
    })


# name -> [(DataFrame, search_range, kwargs), ...]: the calls each test of
# tests/test_link.py and tests/test_link_device.py makes
SCENES = {
    "two_straight_trajectories": lambda: [(_traj_df([
        [(t, 10.0 + 0.5 * t, 10.0) for t in range(5)],
        [(t, 30.0, 30.0 + 0.5 * t) for t in range(5)]]), 2.0, {})],
    "out_of_range_starts_new_particle": lambda: [(_traj_df(
        [[(0, 10.0, 10.0), (1, 10.0, 20.0)]]), 5.0, {})],
    "memory_bridges_gap": lambda: [
        (_traj_df([[(0, 10.0, 10.0), (1, 10.5, 10.0), (3, 11.5, 10.0)]]),
         2.0, {"memory": m}) for m in (0, 1)],
    "nearest_wins_on_contention": lambda: [(pd.DataFrame({
        "frame": [0, 0, 1, 1], "y": [10.0, 14.0, 10.5, 13.6],
        "x": [10.0] * 4}), 5.0, {})],
    "original_order_preserved": lambda: [(_traj_df(
        [[(1, 10.0, 10.0)], [(0, 20.0, 20.0)]]), 2.0, {})],
    "3d_linking": lambda: [(pd.DataFrame({
        "frame": [0, 1, 2], "z": [5.0, 5.4, 5.8], "y": [10.0] * 3,
        "x": [10.0, 10.2, 10.4]}), 1.0, {})],
    "many_random_walkers": lambda: [
        (_random_walkers(np.random.default_rng(1234)), 3.0, {})],
    "subnet_optimal_beats_greedy": lambda: [(pd.DataFrame({
        "y": [0.0] * 4, "x": [0.0, 1.0, 0.55, 1.8],
        "frame": [0, 0, 1, 1]}), 1.0, {})],
    "filter_stubs": lambda: [(_filter_stubs_scene(), 2.0, {})],
    "device_matches_host_unambiguous": lambda: [
        (_walkers(np.random.default_rng(1234)), 3.0, {})],
    "device_memory_bridges_gap": lambda: [
        (_memory_gap(), 2.0, {"memory": m}) for m in (0, 1)],
    "device_new_particles_on_entry": lambda: [(pd.DataFrame({
        "frame": [0, 1, 1], "y": [10.0, 10.2, 40.0],
        "x": [10.0, 10.0, 40.0]}), 2.0, {})],
    "device_varying_counts": lambda: [
        (_varying_counts(), 2.0, {"memory": 1})],
    "device_link_empty": lambda: [
        (pd.DataFrame(columns=["y", "x", "frame"]), 3.0, {})],
    "device_link_frame_gap_respects_memory": lambda: [
        (pd.DataFrame({"frame": [0, 2], "y": [10.0, 10.2],
                       "x": [10.0, 10.1]}), 3.0, {"memory": m})
        for m in (0, 1)],
    "device_auction_contended_subnet": lambda: [(pd.DataFrame({
        "y": [0.0] * 4, "x": [0.0, 1.0, 0.55, 1.8],
        "frame": [0, 0, 1, 1]}), 1.0, {})],
    "device_auction_random_crossings": lambda: [
        (f, 1.2, {}) for f in _crossings(np.random.default_rng(1234), 6)],
    "binned_matches_dense_device": lambda: [
        (_walkers(np.random.default_rng(1234), n=10, T=10), 3.0, {})],
    "binned_matches_host_random_crossings": lambda: [
        (f, 1.2, {}) for f in _crossings(np.random.default_rng(4321), 4)],
    "binned_memory_bridges_gap": lambda: [
        (_memory_gap(), 2.0, {"memory": m}) for m in (0, 1)],
    "binned_cell_boundary_pairs": lambda: [(_cell_boundary(), 5.0, {})],
    "tied_bids": lambda: [(_tied_bids(), 3.0, {"memory": m})
                          for m in (0, 2)],
}


def _port_link(f, sr, backend, **kw):
    dev = {} if backend == "host" else {"device": "cpu"}
    return ctt.link(f.copy(), sr, backend=backend, **dev, **kw)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scene", list(SCENES))
def test_link_matches_reference(scene, backend):
    for f, sr, kw in SCENES[scene]():
        ref = _ref().link(f.copy(), sr, backend=backend, **kw)
        out = _port_link(f, sr, backend, **kw)
        pd.testing.assert_frame_equal(out, ref)
        assert out["particle"].dtype == ref["particle"].dtype
        assert out.attrs["link_backend"] == ref.attrs["link_backend"]


def test_tied_bids_take_the_first_index():
    """The ties of _tied_bids resolve to the lowest index in the auctions:
    of two equal bids the first feature wins the track, and a feature
    equidistant from two tracks bids on the first."""
    f = _tied_bids()
    for backend in ("device", "device-binned"):
        p = _port_link(f, 3.0, backend)["particle"].to_numpy()
        assert p[1] == p[0] and p[2] != p[0]        # feature 1 of 2 wins
        assert p[5] == p[3]                          # the first track
        assert p[8] == p[6] and p[9] == p[7]         # the square


def test_filter_stubs_matches_reference():
    linked = _port_link(_filter_stubs_scene(), 2.0, "host")
    for threshold in (2, 5):
        pd.testing.assert_frame_equal(
            ctt.filter_stubs(linked, threshold=threshold),
            _ref().filter_stubs(linked, threshold=threshold))
    for m in (ctt, _ref()):
        with pytest.raises(ValueError):
            m.filter_stubs(_filter_stubs_scene())
    assert ctt.link_df is ctt.link


def test_auto_routes_as_the_reference():
    """'auto' takes the dense auction up to 2,048 features in the fullest
    frame and the binned one past it, with the same ids as the
    reference's 'auto'."""
    rng = np.random.default_rng(7)
    small = _walkers(rng)
    pos = rng.uniform(0, 600, (2049, 2))
    big = pd.DataFrame({
        "frame": np.repeat([0, 1], 2049),
        "y": np.concatenate([pos[:, 0], pos[:, 0] + 0.3]),
        "x": np.concatenate([pos[:, 1], pos[:, 1] - 0.2]),
    })
    for f, want in ((small, "device"), (big, "device-binned")):
        ref = _ref().link(f.copy(), 3.0, backend="auto")
        out = ctt.link(f.copy(), 3.0, backend="auto", device="cpu")
        assert out.attrs["link_backend"] == ref.attrs["link_backend"] == want
        pd.testing.assert_frame_equal(out, ref)


def test_pad_frames_matches_reference():
    from clustertracking_tpu.link import _pad_frames as ref_pad

    rng = np.random.default_rng(3)
    f = pd.DataFrame({"frame": rng.permutation([0, 0, 0, 2, 2, 5, 5, 5, 5]),
                      "y": rng.uniform(0, 9, 9), "x": rng.uniform(0, 9, 9)})
    for a, b in zip(_pad_frames(f, ["y", "x"], "frame"),
                    ref_pad(f, ["y", "x"], "frame")):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _linker_frames(rng, T=8, n=15):
    """Walkers that blink (each frame drops a random subset) and crowd, so
    tracks retire, return within memory, and subnets contend."""
    pos = rng.uniform(0, 8, (n, 2))
    frames = []
    for _ in range(T):
        pos = pos + rng.normal(0, 0.4, pos.shape)
        frames.append(pos[rng.uniform(size=n) < 0.8].copy())
    return frames


@pytest.mark.parametrize("memory", [0, 2])
def test_linker_state_after_every_frame(memory):
    from clustertracking_tpu.link import Linker as RefLinker

    frames = _linker_frames(np.random.default_rng(memory))
    a, b = Linker(1.5, memory), RefLinker(1.5, memory)
    for t, pos in enumerate(frames):
        np.testing.assert_array_equal(a.advance(t, pos), b.advance(t, pos))
        assert a.state() == b.state()
    # a state the reference wrote (through JSON, as the checkpoint does)
    # resumes in the port's Linker
    b2 = RefLinker(1.5, memory)
    for t, pos in enumerate(frames[:4]):
        b2.advance(t, pos)
    a2 = Linker.from_state(json.loads(json.dumps(b2.state())))
    for t, pos in enumerate(frames[4:], start=4):
        np.testing.assert_array_equal(a2.advance(t, pos), b2.advance(t, pos))
        assert a2.state() == b2.state()


def test_linker_matches_reference_on_random_subnets():
    """tests/test_link.py::test_subnet_optimal_matches_bruteforce's 25
    contended frames: the same ids from both Linkers."""
    from clustertracking_tpu.link import Linker as RefLinker

    rng = np.random.default_rng(1234)
    for _ in range(25):
        tracks = rng.uniform(0, 3, (int(rng.integers(1, 5)), 2))
        feats = rng.uniform(0, 3, (int(rng.integers(1, 5)), 2))
        ids = []
        for lk in (Linker(1.0, 0), RefLinker(1.0, 0)):
            lk.advance(0, tracks)
            ids.append(lk.advance(1, feats))
        np.testing.assert_array_equal(ids[0], ids[1])


def test_link_refusals():
    f = _memory_gap()
    with pytest.raises(TypeError, match="Mesh"):   # not the port's Mesh
        ctt.link(f, 2.0, mesh=object())
    with pytest.raises(ValueError):
        ctt.link(f, 2.0, backend="nearest")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ctt.link(f, 2.0, backend="device")


def test_auction_stats():
    """The auctions report their rounds and host syncs per frame; the
    syncs follow the check points 1, 2, 4, 8, ..."""
    f = _crossings(np.random.default_rng(1234), 1)[0]
    pos, valid, _ = _pad_frames(f, ["y", "x"], "frame")
    for fn in (link_on_device, link_on_device_binned):
        kw = {} if fn is link_on_device else {"bounds": ((0.0, 64.0),) * 2}
        fn(torch.as_tensor(pos), torch.as_tensor(valid), 1.2, **kw)
        st = fn.last_stats
        assert st["frames"] == 2 and len(st["rounds"]) == 2
        assert st["rounds"][0] == st["syncs"][0] == 1   # no live track
        assert 1 <= st["syncs"][1] <= 8 and st["rounds"][1] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["device", "device-binned"])
@pytest.mark.parametrize("scene", [s for s in SCENES if s.startswith(
    ("device", "binned"))] + ["tied_bids"])
def test_auction_on_the_card_matches_cpu(scene, backend):
    """The auctions on CUDA against the same call on the CPU, particle
    for particle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for f, sr, kw in SCENES[scene]():
        on_card = ctt.link(f.copy(), sr, backend=backend, device="cuda", **kw)
        if backend == "device" and len(f):
            assert link_on_device.last_stats["route"] == "kernel"
        pd.testing.assert_frame_equal(on_card, _port_link(f, sr, backend,
                                                          **kw))


# ------------------------------------------------- the dense auction's routes

@pytest.mark.parametrize("device_type,want", [
    ("cpu", "torch"), ("cuda", "kernel"), ("mps", "torch"), ("meta", "torch"),
])
def test_auction_route(device_type, want):
    """The dense auction takes the kernel on CUDA, whatever K, memory and
    D (the library puts the state in shared or global memory), and the
    torch loop on every other device."""
    assert auction_route(device_type) == want


@pytest.mark.parametrize("D", [1, 3, 4])
def test_cpu_dense_auction_keeps_the_torch_loop_for_any_d(D):
    """On CPU tensors every D runs the torch loop, as before the kernel:
    route 'torch', no launch, the particles of ``_link_torch``."""
    rng = np.random.default_rng(5)
    pos = torch.as_tensor(np.cumsum(rng.normal(0, 0.3, (6, 9, D)), axis=0)
                          .astype(np.float32))
    valid = torch.as_tensor(rng.uniform(size=(6, 9)) < 0.9)
    launches = link_on_device.launches_kernel
    out = link_on_device(pos, valid, 1.0, 1)
    assert link_on_device.last_stats["route"] == "torch"
    assert link_on_device.launches_kernel == launches
    assert torch.equal(out, _link_torch(pos, valid, 1.0, 1))


@pytest.mark.parametrize("case", ["valid_shape", "no_feature", "memory"])
def test_link_kernel_refuses_bad_problems(case):
    """The kernel route refuses, before it loads the library, a valid mask
    of another shape, frames with no feature slot (the torch loop fails on
    them too) and a negative memory."""
    pos, memory = torch.zeros(3, 4, 2), 1
    valid = torch.ones(3, 4, dtype=torch.bool)
    if case == "valid_shape":
        valid = torch.ones(3, 5, dtype=torch.bool)
    elif case == "no_feature":
        pos, valid = torch.zeros(3, 0, 2), torch.ones(3, 0, dtype=torch.bool)
    else:
        memory = -1
    launches = link_on_device.launches_kernel
    with pytest.raises(ValueError, match="link_on_device"):
        _link_kernel(pos, valid, 1.0, memory, 64)
    assert link_on_device.launches_kernel == launches


def test_cpu_dense_auction_takes_the_torch_loop():
    """On CPU tensors ``link_on_device`` is the torch loop: route 'torch',
    no kernel launch, host syncs at the check points, rounds that stop at
    a check point, and the particles of ``_link_torch``."""
    f = _crossings(np.random.default_rng(1234), 1)[0]
    pos, valid, _ = _pad_frames(f, ["y", "x"], "frame")
    pos, valid = torch.as_tensor(pos), torch.as_tensor(valid)
    launches = link_on_device.launches_kernel
    out = link_on_device(pos, valid, 1.2)
    st = link_on_device.last_stats
    assert st["route"] == "torch"
    assert link_on_device.launches_kernel == launches
    assert st["rounds"][0] == st["syncs"][0] == 1      # no live track
    assert 1 <= st["syncs"][1] <= 8
    assert all(r in _check_points(64) for r in st["rounds"])
    assert torch.equal(out, _link_torch(pos, valid, 1.2))


def _dimer_video(seed, step, T=100, dimers=50, bond=5.0, frame=512,
                 blink=0.05):
    """Config 2's linking problem as truth rows: 50 Brownian dimers (100
    features) over 100 frames of 512², centres stepping ``step`` px a
    frame per axis; each feature misses a frame with probability
    ``blink``, so tracks retire and come back within memory."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(12, frame - 12, (dimers, 2))
    ang = rng.uniform(0, np.pi, dimers)
    rows = []
    for t in range(T):
        c = np.clip(c + rng.normal(0, step, c.shape), 10, frame - 10)
        ang = ang + rng.normal(0, 0.1, dimers)
        half = 0.5 * bond * np.stack([np.sin(ang), np.cos(ang)], -1)
        feats = np.concatenate([c + half, c - half])
        keep = rng.uniform(size=len(feats)) >= blink
        rows += [{"frame": t, "y": y, "x": x} for y, x in feats[keep]]
    return pd.DataFrame(rows)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both_routes(pos, valid, sr, memory=0, auction_rounds=64):
    """The kernel route and the torch loop on the same CUDA tensors: the
    same particles, one launch and no host sync a frame on the kernel
    route, and each frame's loop rounds the first check point at or past
    the kernel's.  Returns the kernel route's ``last_stats``."""
    dev = _card()
    pos = torch.as_tensor(pos, device=dev)
    valid = torch.as_tensor(valid, device=dev)
    launches = link_on_device.launches_kernel
    got = link_on_device(pos, valid, sr, memory, auction_rounds)
    st = link_on_device.last_stats
    assert st["route"] == "kernel"
    assert link_on_device.launches_kernel == launches + 1
    want = _link_torch(pos, valid, sr, memory, auction_rounds)
    loop = link_on_device.last_stats
    assert torch.equal(got, want)
    assert got.dtype == torch.int32 and got.device == want.device
    assert st["frames"] == len(pos) and st["syncs"] == [0] * len(pos)
    pts = _check_points(auction_rounds)
    assert loop["rounds"] == [next(c for c in pts if c >= r)
                              for r in st["rounds"]]
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("scene", [s for s in SCENES
                                   if s != "device_link_empty"])
def test_link_kernel_matches_the_torch_loop(scene):
    """Every link scene through both routes of the dense auction."""
    for f, sr, kw in SCENES[scene]():
        pos, valid, _ = _pad_frames(f, guess_pos_columns(f), "frame")
        _both_routes(pos, valid, sr, kw.get("memory", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,step", [(0, 0.5), (1, 1.0), (2, 1.5)])
def test_link_kernel_matches_the_torch_loop_on_dimer_videos(seed, step):
    """Config 2's size (100 frames, 100 features, search range 3, memory
    6) through both routes."""
    f = _dimer_video(seed, step)
    pos, valid, _ = _pad_frames(f, ["y", "x"], "frame")
    st = _both_routes(pos, valid, 3.0, memory=6)
    assert len(st["rounds"]) == 100 and min(st["rounds"]) >= 1


def _edge_case(name):
    """(positions, valid, search_range, memory) of one edge case."""
    rng = np.random.default_rng(11)
    if name == "empty_frame":               # frame 2 has no rows
        f = _walkers(rng, n=6, T=8)
        pos, valid, _ = _pad_frames(f[f["frame"] != 2], ["y", "x"], "frame")
        assert not valid[2].any()
        return pos, valid, 3.0, 1
    if name == "no_valid_feature":          # rows there, none valid
        pos, valid, _ = _pad_frames(_walkers(rng, n=6, T=8), ["y", "x"],
                                    "frame")
        valid[3] = False
        return pos, valid, 3.0, 2
    if name == "one_feature":               # K = 1
        f = _traj_df([[(t, 10.0 + 0.7 * t * (t % 3), 10.0)
                       for t in range(8) if t != 4]])
        pos, valid, _ = _pad_frames(f, ["y", "x"], "frame")
        return pos, valid, 2.0, 1
    if name == "memory_0":                  # M = 2K
        pos, valid, _ = _pad_frames(_linker_frames_df(rng), ["y", "x"],
                                    "frame")
        return pos, valid, 1.5, 0
    # D = 1, 3, 4: blinking walkers in a box
    T, K, D = 10, 24, {"1d": 1, "3d": 3, "4d": 4}[name]
    pos = np.cumsum(rng.normal(0, 0.4, (T, K, D)), axis=0) + rng.uniform(
        0, 8 * 24 ** (1 / D - 1 / 3), (1, K, D))
    return pos.astype(np.float32), rng.uniform(size=(T, K)) < 0.85, 1.5, 2


def _linker_frames_df(rng):
    frames = _linker_frames(rng)
    return pd.DataFrame([{"frame": t, "y": y, "x": x}
                         for t, p in enumerate(frames) for y, x in p])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["empty_frame", "no_valid_feature",
                                  "one_feature", "memory_0", "1d", "3d",
                                  "4d"])
def test_link_kernel_edge_cases(name):
    """An empty frame, a frame with no valid feature, K = 1, memory 0 and
    D = 1, 3 and 4 (the instantiation with D read at run time for 1 and
    4) through both routes."""
    pos, valid, sr, memory = _edge_case(name)
    _both_routes(pos, valid, sr, memory)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 2])
def test_link_kernel_round_cap(cap):
    """The crossing scenes with ``auction_rounds`` 1 and 2: the cap binds
    (some frame needs more rounds), and both routes still agree."""
    binds = False
    for scene in ("device_auction_random_crossings",
                  "binned_matches_host_random_crossings", "tied_bids"):
        for f, sr, kw in SCENES[scene]():
            pos, valid, _ = _pad_frames(f, ["y", "x"], "frame")
            full = _both_routes(pos, valid, sr, kw.get("memory", 0))
            binds |= max(full["rounds"]) > cap
            st = _both_routes(pos, valid, sr, kw.get("memory", 0), cap)
            assert max(st["rounds"]) <= cap
    assert binds


def _dense_walkers(K, T, D=2, seed=3):
    """K walkers a frame in a box that holds ~2 a search range² (search
    range 3), stepping 1 px a frame per axis, each missing a frame with
    probability 0.1: positions [T, K, D] and valid [T, K]."""
    rng = np.random.default_rng(seed)
    side = 3.0 * np.sqrt(K / 2.0)
    pos = rng.uniform(0, side, (1, K, D)) + np.cumsum(
        rng.normal(0, 1.0, (T, K, D)), axis=0)
    return pos.astype(np.float32), rng.uniform(size=(T, K)) >= 0.1


def _largest_shared_k(memory, D):
    """The largest K whose state the library keeps in shared memory."""
    lib = _library()
    lo, hi = 1, 4096
    assert lib.link_auction_workspace_bytes(lo, D, memory) == 0
    assert lib.link_auction_workspace_bytes(hi, D, memory) > 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if lib.link_auction_workspace_bytes(mid, D, memory) == 0:
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["shared", "global"])
def test_link_kernel_at_the_shared_memory_edge(side):
    """At memory 6, the largest K whose state fits the block's shared
    memory (with the kernel's static bytes) and the next, whose state the
    library moves to a global workspace: both launch, and both equal the
    torch loop."""
    _card()
    K = _largest_shared_k(6, 2) + (side == "global")
    assert K * 8 * 36 > 200_000          # near 227 KB, not below it
    pos, valid = _dense_walkers(K, 4)
    st = _both_routes(pos, valid, 3.0, memory=6)
    assert st["state"] == side


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 3])
def test_link_kernel_at_the_auto_limit(D):
    """'auto' sends up to 2,048 features to the dense auction: at memory 6
    that is 16,384 track slots, in the global workspace, through both
    routes."""
    pos, valid = _dense_walkers(2048, 3, D=D)
    st = _both_routes(pos, valid, 3.0, memory=6)
    assert st["state"] == "global"


@pytest.mark.cuda
def test_config_2_state_is_in_shared_memory():
    """Config 2's video (K 100, memory 6) keeps its state in shared
    memory."""
    _card()
    f = _dimer_video(0, 1.0, T=5)
    pos, valid, _ = _pad_frames(f, ["y", "x"], "frame")
    assert _both_routes(pos, valid, 3.0, memory=6)["state"] == "shared"
