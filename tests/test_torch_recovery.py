"""``track``'s recovery passes, reduced-precision frame transfer and the
diagnostics of the port, held to the JAX package on the same numpy
inputs, with the port on the CPU.

What has to agree:

- ``_old_rms_on_footprint`` (host numpy in both): rms and noise of every
  cluster within 1e-6 relative, on a float32 residual frame and on the
  same frame rounded through float16, as the split-probe stage fetches
  it (both frameworks round to nearest even: the roundings are
  bit-equal);
- ``_ResidualReader``: every residual frame within 1e-4 × the largest
  signal (the render sums in another order, see tests/test_torch_synth.py);
- ``track(recover_passes=1)`` on tests/test_track.py's scenes: the
  merged-features scene with noise σ=2 and the split-probe scene (probe
  on and off) give the same rows in the same order, positions within
  1e-4 px and every ledger count equal; ``transfer_dtype='float16'``
  likewise on the dimer video; a checkpointed run with recovery gives
  JAX's checkpointed rows;
- ``summary_by_backend`` the reference's on one ``refine_leastsq`` call,
  tag for tag (JAX's 'xla' is the port's 'cpu-torch' there).

The merged-features scene as the reference draws it is noise-free: away
from the features the residual is exactly zero, the locate threshold
falls to zero, and candidates 1e-18–1e-4 of the signal high come from the
two frameworks' float32 rounding (their exp and convolution differ in
the last bits).  Their count, the clusters they pull into the refit and
the zero-signal prunes differ between the packages, and the refit of a
noise-free blended pair ends at the float32 floor (rms ~1e-7), where
positions move by up to ~1e-3 px.  On that scene the test holds the
candidates that carry signal (above 1e-3 of it) equal, every output row
within POS_FLOOR_ATOL of a row of JAX's, and the reference test's own
assertions; the noisy copy holds everything.

Known faults of the reference on this path (ROADMAP queue 3), each with
a test stating that the port fixes it: the rows an over-cap drop leaves
moved and halved (pipeline.py:802-810), the -1 gate sentinel
(pipeline.py:360, :362), float16 overflow (pipeline.py:1243) and the
docstring's accept ratio (pipeline.py:220).
"""
import functools
import json

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch import pipeline as tp


@pytest.fixture(autouse=True, scope="module")
def reference_statistics():
    """Threshold statistics from the 4×-strided sample on every frame, as
    the reference takes them (``pipeline._FULL_STATS_BELOW = None``), so
    that this module's scenes under 256² compare with it."""
    keep, tp._FULL_STATS_BELOW = tp._FULL_STATS_BELOW, None
    yield
    tp._FULL_STATS_BELOW = keep


torch.set_num_threads(1)

track_cpu = functools.partial(ctt.track, device="cpu")
POS_ATOL = 1e-4
POS_FLOOR_ATOL = 1e-3   # px: noise-free fits at the float32 floor
POS_CAP_ATOL = 1e-3     # px: lanes stopped at the refit's iteration cap
COST_RTOL = 1e-3      # chip_smoke.py's COST_RTOL
FOOT_RTOL = 1e-6
SIGNAL_RTOL = 1e-4
WALLS = "_s"
AUCTION = ("link_rounds", "link_syncs")


def _ref():
    import clustertracking_tpu as ct

    return ct


def _jp():
    import clustertracking_tpu.pipeline as jp

    return jp


def _counts(ledger):
    """The ledger without its stage walls and without the device auction's
    rounds and host syncs, which the port alone counts
    (test_torch_spans.py holds them)."""
    return {k: v for k, v in ledger.items()
            if not k.endswith(WALLS) and k not in AUCTION}


def _same_rows(out, ref, atol=POS_ATOL, hold_capped=True):
    """The same rows in the same order, positions within ``atol`` px, the
    same trajectory and cluster partitions.  Rows whose fit did not
    converge in either package are the recovery refit's lanes stopped at
    its iteration cap (16 a round, by design): there JAX's and the port's
    roundings of an unfinished descent part by up to POS_CAP_ATOL px at
    the same cost, so they are held by cost (COST_RTOL) and POS_CAP_ATOL.
    ``hold_capped=False`` (the card against the CPU, where the kernels
    and PyTorch's CPU ops part further on such lanes) holds them by the
    rows and partitions only, as chip_smoke.py's [track_r] does."""
    assert list(out.columns) == list(ref.columns)
    assert len(out) == len(ref)
    np.testing.assert_array_equal(out["frame"].to_numpy(),
                                  ref["frame"].to_numpy())
    capped = ~(out["fit_converged"].to_numpy(bool)
               & ref["fit_converged"].to_numpy(bool))
    pos_o, pos_r = out[["y", "x"]].to_numpy(), ref[["y", "x"]].to_numpy()
    np.testing.assert_allclose(pos_o[~capped], pos_r[~capped], rtol=0,
                               atol=atol)
    if hold_capped:
        np.testing.assert_allclose(pos_o[capped], pos_r[capped], rtol=0,
                                   atol=max(atol, POS_CAP_ATOL))
        np.testing.assert_allclose(out["cost"].to_numpy()[capped],
                                   ref["cost"].to_numpy()[capped],
                                   rtol=COST_RTOL)
    for col in ("particle", "cluster"):
        a, b = out[col].to_numpy(), ref[col].to_numpy()
        _, ia = np.unique(a, return_inverse=True)
        _, ib = np.unique(b, return_inverse=True)
        # the same partition: equal ids map one to one
        pairs = set(zip(ia.tolist(), ib.tolist()))
        assert len(pairs) == len(set(ia.tolist())) == len(set(ib.tolist()))


def _merged_scene(noise=0.0):
    """tests/test_track.py::test_recover_passes_finds_merged_features'
    scene: 3 frames of 96×96, three dimers at hard radius 1.75 (one
    intensity maximum each), size 1.6, signal 150; with ``noise`` > 0 a
    seeded normal noise of that σ is added to each frame."""
    rng = np.random.default_rng(4)
    rows = []
    for t in range(3):
        for c in [(24.0, 24.0), (24.0, 72.0), (72.0, 40.0)]:
            pos = artificial.gen_cluster_locations(
                np.asarray(c) + rng.uniform(-1, 1, 2), 2,
                hard_radius=1.75, ndim=2, angle=rng.uniform(0, np.pi))
            for p in pos:
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 150.0})
    truth = pd.DataFrame(rows)
    reader = []
    for t in range(3):
        img = artificial.draw_spots(
            (96, 96), truth[truth["frame"] == t][["y", "x"]].to_numpy(),
            1.6, 150.0).astype(np.float32)
        if noise:
            img = img + np.random.default_rng(7 + t).normal(
                0, noise, img.shape).astype(np.float32)
        reader.append(img)
    return truth, reader


MERGED_KW = dict(diameter=9, separation=6, search_range=3.0,
                 param_val={"size": 1.6}, param_mode={"size": "const"})


def _split_scene():
    """tests/test_track.py::test_split_probe_recovers_absorbed_pairs'
    scene: 4 singles and 2 pairs 2.2 px apart (one blob each) at size
    1.6, signal 150, noise σ=2, on one 128×128 frame."""
    rng = np.random.default_rng(4)
    rows = []
    img = np.zeros((128, 128), np.float32)
    for k in range(4):
        rows.append(np.array([15.0 + 12 * k + rng.uniform(-1, 1),
                              20.0 + rng.uniform(-1, 1)]))
    for k in range(2):
        c = np.array([40.0 + 30 * k + rng.uniform(-1, 1),
                      85.0 + rng.uniform(-1, 1)])
        ang = rng.uniform(0, np.pi)
        v = np.array([np.sin(ang), np.cos(ang)])
        rows.append(c + 1.1 * v)
        rows.append(c - 1.1 * v)
    truth = np.asarray(rows)
    for p in truth:
        artificial.draw_feature(img, p, 1.6, 150.0)
    img += rng.normal(0, 2.0, img.shape).astype(np.float32)
    return truth, [img]


def _truth_within(out, truth, tol):
    """tests/test_track.py's check: every truth feature of every frame has
    an output row within ``tol`` px."""
    for t in sorted(truth["frame"].unique()):
        tg = truth[truth["frame"] == t][["y", "x"]].to_numpy()
        og = out[out["frame"] == t][["y", "x"]].to_numpy()
        d, _ = cKDTree(og).query(tg, k=1)
        assert d.max() < tol, (t, d.max())


def _ledger_balances(led):
    """tests/test_track.py's ledger identities: located + split-probes −
    the drops = recovered, and the ghosts split by gate.  (That test also
    asserts residual_candidates ≥ recovered_candidates, which holds only
    while the drops outnumber the split-probes: JAX's own run of the noisy
    copy of its scene has 6 and 9, and the port's run of the noise-free
    scene 15 and 16, one more rounding-level candidate than JAX's 14 and
    14.  It is left out here.)"""
    n_gates = (led.get("recovery_dropped_on_top_of_fit", 0)
               + led.get("recovery_dropped_redundant_lobe", 0)
               + led.get("recovery_dropped_over_cap", 0))
    assert (led["residual_candidates"] + led.get("recovery_split_probes", 0)
            - n_gates == led["recovered_candidates"])
    if led.get("ghosts_pruned"):
        assert led["ghosts_pruned"] == (
            led.get("recovery_rejected_likelihood", 0)
            + led.get("recovery_pruned_zero_signal", 0)
            + led.get("recovery_pruned_low_signal", 0)
            + led.get("recovery_pruned_displacement", 0)
            + led.get("recovery_pruned_duplicate", 0))


# --------------------------------------------------------------- footprint

def _footprint_case(ndim):
    """A residual frame (features plus noise σ=2, a quarter of them left
    unrendered, so their footprints carry an unmodelled feature) and the
    clusters of its rows, with dimers, trimers and singles."""
    rng = np.random.default_rng(21)
    shape = (64, 64) if ndim == 2 else (16, 40, 40)
    cols = ["y", "x"] if ndim == 2 else ["z", "y", "x"]
    pos = artificial.gen_random_locations(shape, 24 if ndim == 2 else 12,
                                          margin=4, rng=rng)
    rows = []
    for k, p in enumerate(pos):
        n = 1 + k % 3
        for j in range(n):
            q = p + 2.5 * j * np.eye(ndim)[-1]
            rows.append(dict(zip(cols, q), signal=rng.uniform(80, 160),
                             frame=0))
    g = pd.DataFrame(rows)
    from clustertracking_tpu_torch.find import find_clusters

    g = find_clusters(g, 4.0)
    img = np.zeros(shape)
    for r in g.itertuples():
        artificial.draw_feature(img, [getattr(r, c) for c in cols], 1.6,
                                r.signal)
    drawn = g.sample(frac=0.75, random_state=0)
    model = np.zeros(shape)
    for r in drawn.itertuples():
        artificial.draw_feature(model, [getattr(r, c) for c in cols], 1.6,
                                r.signal)
    res = (img - model + rng.normal(0, 2.0, shape)).astype(np.float32)
    return g, res, cols


@pytest.mark.parametrize("case", ["2d", "2d_float16", "3d"])
def test_footprint_reference_matches(case):
    """``_old_rms_on_footprint`` on one residual frame and table: rms and
    noise of every cluster within 1e-6 relative; the float16 case passes
    the frame as the split-probe stage fetches it, rounded through
    float16 by each framework (bit-equal)."""
    import jax.numpy as jnp

    g, res, cols = _footprint_case(3 if case == "3d" else 2)
    diameter = 9 if case != "3d" else (5, 9, 9)
    if case == "2d_float16":
        host_t = torch.as_tensor(res).to(torch.float16).to(
            torch.float32).numpy()
        host_j = np.asarray(jnp.asarray(res, jnp.float16)).astype(np.float32)
        np.testing.assert_array_equal(host_t, host_j)
        kw_t, kw_j = {"host_frames": {0: host_t}}, {"host_frames": {0: host_j}}
    else:
        kw_t = kw_j = {}
    rms_t, noise_t = tp._old_rms_on_footprint(
        g, [torch.as_tensor(res)], diameter, cols, "frame", **kw_t)
    rms_j, noise_j = _jp()._old_rms_on_footprint(
        g, [res], diameter, cols, "frame", **kw_j)
    assert rms_t.keys() == rms_j.keys() == set(g["cluster"].unique())
    for cid in rms_j:
        np.testing.assert_allclose(rms_t[cid], rms_j[cid], rtol=FOOT_RTOL)
        np.testing.assert_allclose(noise_t[cid], noise_j[cid],
                                   rtol=FOOT_RTOL)
    if case == "2d_float16":
        # the rounding reaches the statistics: the footprints of the
        # float32 frame give other numbers
        rms_32, _ = tp._old_rms_on_footprint(
            g, [torch.as_tensor(res)], diameter, cols, "frame")
        assert any(rms_32[c] != rms_t[c] for c in rms_t)


@pytest.mark.parametrize("shape,full", [
    ((64, 64), True), ((252, 256), True), ((256, 256), False),
    ((512, 512), False), ((1024, 1024), False), ((16, 40, 40), True),
    ((64, 64, 64), False)])
def test_footprint_floor_takes_every_pixel_of_small_frames(shape, full):
    """The frame's noise floor of ``_old_rms_on_footprint`` comes from
    every pixel where the 4×-strided sample would hold fewer than
    ``_FULL_STATS_BELOW`` (4,096), as the threshold statistics do;
    configs 2 and 5 (512², 1024²) take the strided sample either way, and
    ``None`` (this module's fixture) is the reference's strided sample on
    every frame (its pipeline.py:1076-1081)."""
    res = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    strided = res[(slice(None, None, 4),) * len(shape)]
    assert np.array_equal(tp._floor_sample(res), strided)
    keep, tp._FULL_STATS_BELOW = tp._FULL_STATS_BELOW, 4096
    try:
        got = tp._floor_sample(res)
    finally:
        tp._FULL_STATS_BELOW = keep
    assert np.array_equal(got, res if full else strided)


@pytest.mark.parametrize("ndim", [2, 3])
def test_footprint_noise_floor_of_a_small_frame_is_the_frames(ndim):
    """On the small footprint scenes, with ``_FULL_STATS_BELOW = 4096``,
    every cluster's noise is floored at the MAD of every pixel of the
    frame; the strided sample, made to read a brighter floor, floors it
    higher, as the reference does."""
    g, res, cols = _footprint_case(ndim)
    res = res.copy()
    res[(slice(None, None, 4),) * ndim] *= 3.0
    diameter = 9 if ndim == 2 else (5, 9, 9)
    _, noise_ref = tp._old_rms_on_footprint(
        g, [torch.as_tensor(res)], diameter, cols, "frame")
    keep, tp._FULL_STATS_BELOW = tp._FULL_STATS_BELOW, 4096
    try:
        _, noise = tp._old_rms_on_footprint(
            g, [torch.as_tensor(res)], diameter, cols, "frame")
    finally:
        tp._FULL_STATS_BELOW = keep
    floor = 1.4826 * float(np.median(np.abs(res - np.median(res))))
    sub = res[(slice(None, None, 4),) * ndim]
    floor_ref = 1.4826 * float(np.median(np.abs(sub - np.median(sub))))
    assert floor_ref > 1.5 * floor
    sig = g.groupby("cluster")["signal"].agg(lambda s: np.abs(s).max())
    assert any(noise[c] < noise_ref[c] for c in noise)
    for c in noise:
        assert noise[c] * sig[c] >= floor * (1 - 1e-6)
        assert noise_ref[c] * sig[c] >= floor_ref * (1 - 1e-6)
        assert noise[c] <= noise_ref[c]


# --------------------------------------------------------- residual reader

@pytest.mark.parametrize("kind", ["iso", "aniso", "ring"])
def test_residual_reader_matches_reference(kind):
    """``_ResidualReader``: frame − render of the accepted fits on every
    frame, within 1e-4 × the largest signal of JAX's; one rogue wide fit
    (size 12) exercises the window's robust scale and truncation; a frame
    with no fits is the frame itself."""
    rng = np.random.default_rng(3)
    shape = (80, 96)
    rows = []
    for t in range(2):
        for p in artificial.gen_random_locations(shape, 30, margin=3,
                                                 rng=rng):
            rows.append({"frame": t, "y": p[0], "x": p[1],
                         "signal": rng.uniform(60, 200),
                         "size": rng.uniform(1.4, 2.0),
                         "size_y": rng.uniform(1.2, 2.2),
                         "size_x": rng.uniform(1.2, 2.2),
                         "thickness": rng.uniform(0.15, 0.3)})
    acc = pd.DataFrame(rows)
    acc.loc[3, "size"] = 12.0
    acc.loc[3, "size_y"] = 12.0
    if kind != "aniso":
        acc = acc.drop(columns=["size_y", "size_x"])
    frames = [rng.normal(50, 20, shape).astype(np.float32) for _ in range(3)]
    fun = "ring" if kind == "ring" else "gauss"
    r_t = tp._ResidualReader(frames, acc, fun, "frame", ["y", "x"], "cpu")
    r_j = _jp()._ResidualReader(frames, acc, fun, "frame", ["y", "x"])
    for t in range(3):
        got = r_t[t]
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(r_j[t]), rtol=0,
                                   atol=SIGNAL_RTOL * 200.0)
        assert r_t[t] is got            # cached for the pass
    np.testing.assert_array_equal(r_t[2].numpy(), frames[2])
    first = r_t[0]
    r_t.drop_cache()
    again = r_t[0]                      # rendered anew, the same bits
    assert again is not first and torch.equal(again, first)


# ------------------------------------------------------------------ scenes

def test_merged_features_scene():
    """tests/test_track.py::test_recover_passes_finds_merged_features as
    drawn (noise-free): the reference test's assertions on the port; the
    located candidates that carry signal equal to JAX's; every output row
    within POS_FLOOR_ATOL of one of JAX's (see the module docstring)."""
    ct = _ref()
    truth, reader = _merged_scene()
    with ctt.diagnostics.collect() as s0:
        out0 = track_cpu(reader, **MERGED_KW)
    stash_t, stash_j = {}, {}
    tp._DEBUG_STASH, _jp()._DEBUG_STASH = stash_t, stash_j
    try:
        with ctt.diagnostics.collect() as s1:
            out1 = track_cpu(reader, recover_passes=1, **MERGED_KW)
        ref1 = ct.track(reader, recover_passes=1, **MERGED_KW)
    finally:
        tp._DEBUG_STASH, _jp()._DEBUG_STASH = None, None
    assert len(out0) < len(truth)
    assert len(out1) == len(truth)
    assert s1.ledger.get("recovered_candidates", 0) > 0
    _ledger_balances(s1.ledger)
    _truth_within(out1, truth, 0.25)
    assert "recovered_candidates" not in s0.ledger
    real = [loc[loc["signal"] > 1e-3 * 150.0][["frame", "y", "x"]].to_numpy()
            for loc in (stash_t["located"][0], stash_j["located"][0])]
    np.testing.assert_array_equal(real[0], real[1])
    assert len(ref1) == len(out1)
    for t in range(3):
        a = out1[out1["frame"] == t][["y", "x"]].to_numpy()
        b = ref1[ref1["frame"] == t][["y", "x"]].to_numpy()
        d, j = cKDTree(b).query(a, k=1)
        assert d.max() <= POS_FLOOR_ATOL and len(set(j)) == len(b)


def test_merged_features_scene_with_noise():
    """The merged-features scene with noise σ=2: the same rows in the same
    order, positions within 1e-4 px, trajectories and clusters alike,
    every ledger count equal; and the reference test's assertions."""
    ct = _ref()
    truth, reader = _merged_scene(noise=2.0)
    with ct.diagnostics.collect() as s_ref:
        ref = ct.track(reader, recover_passes=1, **MERGED_KW)
    with ctt.diagnostics.collect() as s_out:
        out = track_cpu(reader, recover_passes=1, **MERGED_KW)
    _same_rows(out, ref)
    assert _counts(s_out.ledger) == _counts(s_ref.ledger)
    assert s_out.ledger["recovered_candidates"] > 0
    assert all(s_out.ledger[k] >= 0 for k in s_out.ledger
               if k.endswith(WALLS))
    _ledger_balances(s_out.ledger)
    assert len(out) == len(truth)


@pytest.mark.parametrize("probe", [False, True])
def test_split_probe_scene(probe):
    """tests/test_track.py::test_split_probe_recovers_absorbed_pairs with
    the probe off (``_SPLIT_SIG_EXCESS = None``) and on: the same rows,
    ledger and truth count as JAX, and the reference's assertions (off:
    pairs stay lost; on: every feature found, probes recorded)."""
    ct = _ref()
    truth, reader = _split_scene()
    kw = dict(diameter=9, separation=6, search_range=3.0,
              max_cluster_size=8, recover_passes=1)
    old_t, old_j = tp._SPLIT_SIG_EXCESS, _jp()._SPLIT_SIG_EXCESS
    try:
        if not probe:
            tp._SPLIT_SIG_EXCESS = _jp()._SPLIT_SIG_EXCESS = None
        with ct.diagnostics.collect() as s_ref:
            ref = ct.track(reader, **kw)
        with ctt.diagnostics.collect() as s_out:
            out = track_cpu(reader, **kw)
    finally:
        tp._SPLIT_SIG_EXCESS, _jp()._SPLIT_SIG_EXCESS = old_t, old_j
    _same_rows(out, ref)
    assert _counts(s_out.ledger) == _counts(s_ref.ledger)
    ot = out[out["cost"].notna()][["y", "x"]].to_numpy()
    d, _ = cKDTree(ot).query(truth, k=1)
    n = int((d < 1.0).sum())
    if probe:
        assert s_out.ledger.get("recovery_split_probes", 0) > 0
        assert n == len(truth)
    else:
        assert "recovery_split_probes" not in s_out.ledger
        assert n < len(truth)


def _dimer_video(T=4, shape=(80, 80), seed=0):
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
    return truth, artificial.CoordinateReader(truth, shape, size=2.0,
                                              noise_level=2.0)


def test_transfer_float16_matches_reference():
    """``track(transfer_dtype='float16')`` (benchmarks/suite.py::config2's
    variant) on the dimer video with noise σ=2: JAX's rows, positions
    within 1e-4 px, ledger; the frames every stage reads are the float16
    values of the reader's."""
    ct = _ref()
    truth, reader = _dimer_video()
    kw = dict(diameter=7, separation=6.0, search_range=2.0,
              transfer_dtype="float16")
    with ct.diagnostics.collect() as s_ref:
        ref = ct.track(reader, **kw)
    with ctt.diagnostics.collect() as s_out:
        out = track_cpu(reader, **kw)
    _same_rows(out, ref)
    assert _counts(s_out.ledger) == _counts(s_ref.ledger)
    tr = tp._TransferReader(reader, "float16", torch.device("cpu"))
    fr = tr[1]
    assert fr.dtype == torch.float32
    np.testing.assert_array_equal(
        fr.numpy(), reader[1].astype(np.float16).astype(np.float32))
    assert not np.array_equal(fr.numpy(), reader[1].astype(np.float32))
    _truth_within(out, truth, 0.25)


def test_transfer_float16_refuses_overflow():
    """The reference casts pixels above 65504 to inf under float16
    (pipeline.py:1243) and fits garbage; the port raises ValueError naming
    the frame before any stage runs."""
    _, reader = _dimer_video(T=3)
    frames = [reader[t] for t in range(3)]
    frames[2] = frames[2] * 400.0      # peaks ~80,000

    class Counting(list):
        reads = 0

        def __getitem__(self, t):
            Counting.reads += 1
            return list.__getitem__(self, t)

    counted = Counting(frames)
    with ctt.diagnostics.collect() as stats:
        with pytest.raises(ValueError, match="frame 2"):
            track_cpu(counted, diameter=7, transfer_dtype="float16")
    assert stats.ledger == {} and stats.batches == []
    assert Counting.reads == 3          # the check read each frame once
    with np.errstate(over="ignore"):
        assert np.isinf(frames[2].astype(np.float16)).any()
    track_cpu(frames, diameter=7, transfer_dtype=np.float32)


def _checkpoint_scene(noise):
    """tests/test_sharded_api.py::test_checkpoint_with_recover_passes'
    scene (4 frames of 96×96, three merged dimers each), with ``noise``
    σ added by a seeded generator where it is > 0."""
    rng = np.random.default_rng(4)
    rows = []
    for t in range(4):
        for c in [(24.0, 24.0), (24.0, 72.0), (72.0, 40.0)]:
            pos = artificial.gen_cluster_locations(
                np.asarray(c) + rng.uniform(-1, 1, 2), 2, hard_radius=1.75,
                ndim=2, angle=rng.uniform(0, np.pi))
            for p in pos:
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 150.0})
    truth = pd.DataFrame(rows)
    nrng = np.random.default_rng(9)
    reader = [
        (artificial.draw_spots(
            (96, 96), truth[truth["frame"] == t][["y", "x"]].to_numpy(),
            1.6, 150.0) + (nrng.normal(0, noise, (96, 96)) if noise else 0)
         ).astype(np.float32)
        for t in range(4)]
    return truth, reader


CKPT_KW = dict(diameter=9, separation=6, search_range=3.0,
               param_val={"size": 1.6}, param_mode={"size": "const"},
               recover_passes=1)


def _sorted(out):
    return out.sort_values(["frame", "y", "x"]).reset_index(drop=True)


def test_checkpointed_recovery(tmp_path):
    """Recovery passes run within each checkpointed chunk: the reference
    test's assertions on the noise-free scene (2-frame chunks); with
    noise σ=2, JAX's checkpointed rows (positions within 1e-4 px, particle
    ids equal) and, resumed after the first chunk, the uninterrupted
    run's; with one chunk over the whole video, the single-shot host-
    linked run's rows exactly."""
    ct = _ref()
    truth, reader = _checkpoint_scene(0.0)
    out = track_cpu(reader, checkpoint_dir=str(tmp_path / "a"),
                    checkpoint_every=2, **CKPT_KW)
    assert len(out) == len(truth)
    for t in range(4):
        got = out[out["frame"] == t][["y", "x"]].to_numpy()
        want = truth[truth["frame"] == t][["y", "x"]].to_numpy()
        d, _ = cKDTree(got).query(want, k=1)
        assert d.max() < 0.25

    _, noisy = _checkpoint_scene(2.0)
    ref = ct.track(noisy, checkpoint_dir=str(tmp_path / "b"),
                   checkpoint_every=2, **CKPT_KW)
    whole = track_cpu(noisy, checkpoint_dir=str(tmp_path / "c"),
                      checkpoint_every=2, **CKPT_KW)
    a, b = _sorted(whole), _sorted(ref)
    assert len(a) == len(b)
    _same_rows(a, b)
    ck = tmp_path / "d"
    track_cpu(noisy, checkpoint_dir=str(ck), checkpoint_every=2, n_frames=2,
              **CKPT_KW)
    assert json.loads((ck / "state.json").read_text())["next_frame"] == 2
    resumed = track_cpu(noisy, checkpoint_dir=str(ck), checkpoint_every=2,
                        **CKPT_KW)
    pd.testing.assert_frame_equal(_sorted(resumed), a)

    single = track_cpu(noisy, link_backend="host", **CKPT_KW)
    one = track_cpu(noisy, checkpoint_dir=str(tmp_path / "e"),
                    checkpoint_every=4, **CKPT_KW)
    s, o = _sorted(single), _sorted(one)
    np.testing.assert_array_equal(o[["frame", "y", "x"]].to_numpy(),
                                  s[["frame", "y", "x"]].to_numpy())
    np.testing.assert_array_equal(o["particle"].to_numpy(),
                                  s["particle"].to_numpy())


# ------------------------------------------------------ reference faults

def test_rows_left_by_an_over_cap_drop_keep_their_fits():
    """pipeline.py:802-810, fixed.  A bright absorbed pair (two features
    2.2 px apart, fitted as one) is split-probed; with
    ``max_cluster_size=1`` the probe is dropped over the cap, and a faint
    isolated residual candidate keeps the pass going.  The reference then
    emits the original moved by the probe's δ with half its signal and
    its old cost; the port keeps its accepted fit (the main fit's row)."""
    ct = _ref()
    rng = np.random.default_rng(4)
    img = np.zeros((96, 96), np.float32)
    for p in ([20.0, 20.3], [20.6, 60.2], [70.4, 20.5]):
        artificial.draw_feature(img, p, 1.6, 150.0)
    c, v = np.array([60.3, 64.6]), np.array([0.6, 0.8])
    for p in (c + 1.1 * v, c - 1.1 * v):
        artificial.draw_feature(img, p, 1.6, 150.0)
    artificial.draw_feature(img, [40.2, 40.7], 1.6, 10.0)
    img += rng.normal(0, 2.0, img.shape).astype(np.float32)
    kw = dict(diameter=9, separation=6, search_range=3.0,
              max_cluster_size=1)
    cols = ["y", "x", "signal", "cost"]

    def bright(out):
        return out.loc[out["signal"].idxmax() if len(out) else 0]

    main_t = track_cpu([img], **kw)
    main_j = ct.track([img], **kw)
    with ctt.diagnostics.collect() as s_t:
        rec_t = track_cpu([img], recover_passes=1, **kw)
    with ct.diagnostics.collect() as s_j:
        rec_j = ct.track([img], recover_passes=1, **kw)
    assert _counts(s_t.ledger) == _counts(s_j.ledger)
    assert s_t.ledger["recovery_split_probes"] == 1
    assert s_t.ledger["recovery_dropped_over_cap"] >= 1
    assert s_t.ledger["recovered_candidates"] >= 1
    pair_t = bright(main_t)
    # the port: the pair's row is the main fit's, exactly
    after_t = rec_t.loc[((rec_t[["y", "x"]] - pair_t[["y", "x"]]) ** 2).sum(
        axis=1).idxmin()]
    np.testing.assert_array_equal(after_t[cols].to_numpy(float),
                                  pair_t[cols].to_numpy(float))
    # the reference: moved by ≥ 0.85 px, halved, its old cost kept
    pair_j = bright(main_j)
    after_j = rec_j.loc[((rec_j[["y", "x"]] - pair_j[["y", "x"]]) ** 2).sum(
        axis=1).idxmin()]
    moved = float(np.hypot(*(after_j[["y", "x"]].to_numpy(float)
                             - pair_j[["y", "x"]].to_numpy(float))))
    assert moved >= 0.85 - 1e-9         # the probe's least δ
    np.testing.assert_allclose(after_j["signal"], 0.5 * pair_j["signal"],
                               rtol=1e-6)
    assert after_j["cost"] == pair_j["cost"]
    np.testing.assert_allclose(pair_t[cols].to_numpy(float),
                               pair_j[cols].to_numpy(float), rtol=1e-4,
                               atol=POS_ATOL)


@pytest.mark.parametrize("value", [-1, -1.0, np.float32(-1.0),
                                   np.int64(-1)])
def test_gate_sentinel_is_any_minus_one(value):
    """pipeline.py:360 and :362, fixed: the reference takes the default
    only for a Python float -1.0, so -1 or np.float32(-1) become a real
    −1 px displacement gate (every recovered candidate pruned) or a −1
    split excess (every original probed).  The port takes the default for
    any real number equal to -1."""
    assert tp._gate_arg(value, tp._DISP_GATE) == tp._DISP_GATE
    assert tp._gate_arg(value, tp._SPLIT_SIG_EXCESS) == tp._SPLIT_SIG_EXCESS
    assert tp._gate_arg(None, tp._DISP_GATE) is None
    assert tp._gate_arg(2.0, tp._DISP_GATE) == 2.0
    ref_takes_default = isinstance(value, float) and value == -1.0
    assert ref_takes_default == (type(value) is float)


def test_gate_sentinel_in_track():
    """The sentinel through ``track``: the port's ``recover_disp_gate=-1``
    run is its default run; the reference's prunes every recovered
    candidate on displacement."""
    ct = _ref()
    _, reader = _merged_scene(noise=2.0)
    kw = dict(MERGED_KW, recover_passes=1)
    with ctt.diagnostics.collect() as s_def:
        default = track_cpu(reader, **kw)
    with ctt.diagnostics.collect() as s_one:
        minus_one = track_cpu(reader, recover_disp_gate=-1, **kw)
    pd.testing.assert_frame_equal(minus_one, default)
    assert _counts(s_one.ledger) == _counts(s_def.ledger)
    with ct.diagnostics.collect() as s_ref:
        ct.track(reader, recover_disp_gate=-1, **kw)
    led = s_ref.ledger
    survivors = (led["recovered_candidates"]
                 - led.get("recovery_rejected_likelihood", 0)
                 - led.get("recovery_pruned_zero_signal", 0)
                 - led.get("recovery_pruned_low_signal", 0))
    assert led["recovery_pruned_displacement"] == survivors > 0
    assert s_def.ledger.get("recovery_pruned_displacement", 0) == 0


def test_docstring_gives_the_accept_ratio_in_use():
    """pipeline.py:220, fixed: the reference's docstring gives the accept
    ratio's default as 0.8 while its code uses 0.9; the port's says 0.9."""
    assert _jp()._ACCEPT_RATIO == tp._ACCEPT_RATIO == 0.9
    assert "(default 0.8;" in _ref().track.__doc__
    doc = " ".join(ctt.track.__doc__.split())
    assert "``recover_accept_ratio`` (default 0.9)" in doc


# ------------------------------------------------------------- diagnostics

def _diag_scene():
    """tests/test_diagnostics.py::_scene."""
    img = np.zeros((96, 96))
    rows = []
    for center, n in [((25, 25), 2), ((25, 70), 2), ((70, 30), 1)]:
        pos = artificial.draw_cluster(img, center, size=2.5, separation=5.0,
                                      n=n, signal=150.0, angle=0.5)
        for p in pos:
            rows.append({"frame": 0, "y": p[0] + 0.2, "x": p[1] - 0.2,
                         "signal": 150.0, "size": 2.5})
    return img, pd.DataFrame(rows)


def test_summary_by_backend_matches_reference():
    """One refine_leastsq call in each package: the reference's summary
    ({'xla': ...} on the CPU) against the port's on its plain route
    ({'cpu-torch': ...}): the same keys, clusters, positive walls and
    rates; the port's kernel route on the CPU is tagged 'cpu-fused'."""
    ct = _ref()
    img, f = _diag_scene()
    with ct.diagnostics.collect() as s_ref:
        ct.refine_leastsq(f, img, diameter=9, separation=5.5)
    by_ref = s_ref.summary_by_backend()
    assert set(by_ref) == {"xla"}
    for lm_backend, tag in (("torch", "cpu-torch"), ("kernel", "cpu-fused")):
        with ctt.diagnostics.collect() as s_out:
            ctt.refine_leastsq(f, img, diameter=9, separation=5.5,
                               lm_backend=lm_backend, device="cpu")
        by_out = s_out.summary_by_backend()
        assert set(by_out) == {tag}
        o, d = by_out[tag], by_ref["xla"]
        assert set(o) == set(d) == {"n_clusters", "wall_s",
                                    "clusters_per_sec"}
        assert o["n_clusters"] == d["n_clusters"] == 3
        assert o["wall_s"] > 0
        assert o["clusters_per_sec"] == o["n_clusters"] / o["wall_s"]


def test_trace_to_writes_a_readable_trace(tmp_path):
    """``trace_to`` around refine_leastsq on the CPU writes one Chrome
    trace JSON file into the directory, holding the refit's ``stage``
    ranges."""
    img, f = _diag_scene()
    with ctt.diagnostics.trace_to(str(tmp_path)):
        ctt.refine_leastsq(f, img, diameter=9, separation=5.5, device="cpu")
    files = list(tmp_path.glob("*.pt.trace.json*"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"refine.find", "refine.prepare", "solver.setup", "solver.round",
            "solver.kernel", "solver.finish", "refine.drain"} <= names
    assert not any(str(n)[-1:].isdigit() for n in names
                   if str(n).startswith(("refine.", "solver.")))


def test_track_refuses_only_mesh():
    """With recovery passes on, ``track`` refuses only a ``mesh`` that is
    not the port's ``Mesh``."""
    _, reader = _merged_scene()
    with pytest.raises(TypeError, match="Mesh"):
        track_cpu(reader, diameter=9, mesh=object())


# -------------------------------------------------------------------- card

@pytest.mark.cuda
def test_recovery_on_the_card_matches_cpu():
    """The merged-features scene with ``recover_passes=1`` on CUDA: as
    drawn, the reference test's assertions; with noise σ=2, the same rows
    and ledger counts as the CPU, positions of converged fits within
    1e-3 px (the card's fused_lm_2d against the CPU's plain solve), the
    refit's unconverged lanes held by the rows and partitions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    truth, reader = _merged_scene()
    with ctt.diagnostics.collect() as s1:
        out = ctt.track(reader, recover_passes=1, device="cuda", **MERGED_KW)
    assert len(out) == len(truth)
    _ledger_balances(s1.ledger)
    _truth_within(out, truth, 0.25)
    _, noisy = _merged_scene(noise=2.0)
    with ctt.diagnostics.collect() as s_card:
        card = ctt.track(noisy, recover_passes=1, device="cuda", **MERGED_KW)
    with ctt.diagnostics.collect() as s_cpu:
        cpu = track_cpu(noisy, recover_passes=1, **MERGED_KW)
    _same_rows(card, cpu, atol=1e-3, hold_capped=False)
    assert _counts(s_card.ledger) == _counts(s_cpu.ledger)
