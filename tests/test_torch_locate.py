"""Candidate location in the port (``ops/locate.py``, ``pipeline.locate``
and ``_locate_frames``), held to the JAX package on the same numpy inputs.

What has to agree, with the port on the CPU:

- candidates exactly: coordinates, their order, valid flags and the
  candidate count, including plateau ties, frames that overflow
  ``max_features`` (through ``local_maxima_topk``) and uint8 frames;
- the filters (``gaussian_blur``, ``boxcar_background``, ``bandpass``,
  ``tile_threshold_map``) within 1e-5 of the frame's largest magnitude:
  float32 on both sides, the reference's convolution summing its taps in
  another order (1e-5 absolute on a unit-scale frame; the frames below
  reach ~100–400, where a float32 ulp is 8e-6–3e-5);
- the statistics exactly: ``np_median`` and ``np_percentile`` against
  numpy on float32 (the reference's host statistics);
- sizes within 1e-4 relative; the 'signal' column exactly on raw frames,
  and within 1e-5 of the frame's magnitude on filtered ones.

The scenes are tests/test_locate.py's fourteen and the five of
tests/test_locate_robust.py that do not run ``track``, drawn with the
port's copy of ``artificial``; each also keeps the reference's own
assertion on the port's result.  The card test at the end holds locate on
CUDA to the same call on the CPU on a 512² frame.
"""
import functools

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch import pipeline as tp
from clustertracking_tpu_torch.ops import locate as pl
from clustertracking_tpu_torch.pipeline import _locate_frames


@pytest.fixture(autouse=True, scope="module")
def reference_statistics():
    """Threshold statistics from the 4×-strided sample on every frame, as
    the reference takes them (``pipeline._FULL_STATS_BELOW = None``), so
    that this module's scenes under 256² compare with it."""
    keep, tp._FULL_STATS_BELOW = tp._FULL_STATS_BELOW, None
    yield
    tp._FULL_STATS_BELOW = keep


torch.set_num_threads(1)

locate_cpu = functools.partial(ctt.locate, device="cpu")
refine_cpu = functools.partial(ctt.refine_leastsq, device="cpu")

FILTER_RTOL = 1e-5   # of the frame's largest magnitude
SIZE_RTOL = 1e-4


def _jl():
    import clustertracking_tpu.ops.locate as jl

    return jl


def _same_maxima(res, res_j):
    """Exact agreement of (coords, values, valid, n_cand)."""
    for a, b in zip(res, res_j):
        np.testing.assert_array_equal(torch.as_tensor(a).numpy(),
                                      np.asarray(b))


def _same_frame(out, out_j, scale=None):
    """Two locate DataFrames: the same candidates in the same order;
    sizes to SIZE_RTOL; signal exactly, or within FILTER_RTOL·scale."""
    assert list(out.columns) == list(out_j.columns)
    assert len(out) == len(out_j)
    pos = [c for c in ("frame", "z", "y", "x") if c in out.columns]
    np.testing.assert_array_equal(out[pos].to_numpy(), out_j[pos].to_numpy())
    size_cols = [c for c in out.columns if c.startswith("size")]
    np.testing.assert_allclose(out[size_cols].to_numpy(),
                               out_j[size_cols].to_numpy(), rtol=SIZE_RTOL)
    if scale is None:
        np.testing.assert_array_equal(out["signal"].to_numpy(),
                                      out_j["signal"].to_numpy())
    else:
        np.testing.assert_allclose(out["signal"].to_numpy(),
                                   out_j["signal"].to_numpy(),
                                   atol=FILTER_RTOL * scale, rtol=0)


def _locate_both(img, **kw):
    from clustertracking_tpu.pipeline import locate as jax_locate

    return locate_cpu(img, **kw), jax_locate(img, **kw)


# --------------------------------------------------------------------------
# ops/locate.py, function by function
# --------------------------------------------------------------------------
def _stack(shape=(3, 70, 90), seed=0):
    rng = np.random.default_rng(seed)
    st = rng.normal(10, 2, shape).astype(np.float32)
    for p in [(20, 20), (40, 61.3), (55, 30)]:
        if len(shape) == 3:
            artificial.draw_feature(st[0], p, 1.6, 80.0)
        else:
            artificial.draw_feature(st[0], (10,) + p[:1] + (30,), 1.6, 80.0)
    return st


@pytest.mark.parametrize("shape,sigmas", [
    ((3, 70, 90), (1.0, 1.6)), ((3, 70, 90), (0.0, 2.0)),
    ((2, 20, 40, 44), (1.2, 0.8, 0.8))])
def test_gaussian_blur_matches_jax(shape, sigmas):
    st = _stack(shape)
    got = pl.gaussian_blur(torch.from_numpy(st), sigmas).numpy()
    want = np.asarray(_jl().gaussian_blur(st, sigmas))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FILTER_RTOL * np.abs(st).max())


@pytest.mark.parametrize("sizes", [(9, 9), (8, 5), (1, 7)])
def test_boxcar_background_matches_jax(sizes):
    st = _stack()
    got = pl.boxcar_background(torch.from_numpy(st), sizes).numpy()
    want = np.asarray(_jl().boxcar_background(st, sizes))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FILTER_RTOL * np.abs(st).max())


@pytest.mark.parametrize("clip", [True, False])
def test_bandpass_matches_jax(clip):
    st = _stack()
    got = pl.bandpass(torch.from_numpy(st), (1.0, 1.0), (9, 9),
                      clip=clip).numpy()
    want = np.asarray(_jl().bandpass(st, (1.0, 1.0), (9, 9), clip=clip))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FILTER_RTOL * np.abs(st).max())
    assert (got >= 0).all() if clip else (got < 0).any()


@pytest.mark.parametrize("shape,tile", [
    ((3, 70, 90), 16), ((2, 64, 64), 32), ((2, 20, 40, 44), 8)])
def test_tile_threshold_map_matches_jax(shape, tile):
    st = _stack(shape)
    got = pl.tile_threshold_map(torch.from_numpy(st), tile).numpy()
    want = np.asarray(_jl().tile_threshold_map(st, tile))
    assert got.shape == want.shape == st.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FILTER_RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 4, 4, 6)])
def test_bilinear_upsampling_matches_jax_resize_at_the_edges(shape):
    """The tile map's upsampling: F.interpolate(align_corners=False)
    against jax.image.resize(method='linear'), every pixel including the
    clamped edge bands."""
    import jax

    x = np.random.default_rng(3).uniform(0, 50, shape).astype(np.float32)
    size = tuple(4 * s for s in shape[1:])
    mode = "bilinear" if len(shape) == 3 else "trilinear"
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x)[:, None], size=size, mode=mode,
        align_corners=False)[:, 0].numpy()
    want = np.asarray(jax.image.resize(x, (shape[0],) + size, "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 50)
    corner = (slice(None),) + (0,) * (len(shape) - 1)
    np.testing.assert_array_equal(got[corner], x[corner])


@pytest.mark.parametrize("n", [1001, 1000, 16384, 7, 2, 1])
def test_statistics_match_numpy_exactly(n):
    x = np.random.default_rng(n).normal(3, 2, (4, n)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(pl.np_median(t, dim=1).numpy(),
                                  np.median(x, axis=1))
    for q in (0, 37.3, 50, 64, 90, 99.9, 100):
        np.testing.assert_array_equal(pl.np_percentile(t, q, dim=1).numpy(),
                                      np.percentile(x, q, axis=1))


def _peaks_frame():
    img = np.zeros((64, 64), np.float32)
    truth = artificial.gen_nonoverlapping_locations(
        (64, 64), 12, separation=9, margin=6, rng=5)
    rngv = np.random.default_rng(2)
    for p in truth:
        artificial.draw_feature(img, p, 2.0,
                                signal=float(rngv.uniform(50, 150)))
    img[3:5, 40:42] = 60.0                       # a plateau
    return img


@pytest.mark.parametrize("K,thr", [(16, 10.0), (4, 10.0), (64, 0.0)])
def test_local_maxima_and_topk_match_jax(K, thr):
    img = _peaks_frame()
    for name in ("local_maxima", "local_maxima_topk"):
        got = getattr(pl, name)(torch.from_numpy(img), (5, 5), K, thr)
        want = getattr(_jl(), name)(img, (5, 5), K, thr)
        _same_maxima(got, want)


def test_local_maxima_batched_with_map_thresholds():
    """A [T, *S] stack with per-frame and per-pixel thresholds gives each
    frame's single-frame result."""
    st = _stack()
    thr_map = np.full(st.shape, 12.0, np.float32)
    thr_map[:, :, 45:] = 20.0
    for thr in (np.array([12.0, 14.0, 16.0], np.float32), thr_map):
        got = pl.local_maxima(torch.from_numpy(st), (5, 5), 64,
                              torch.from_numpy(thr))
        for k in range(3):
            want = _jl().local_maxima(st[k], (5, 5), 64, thr[k])
            _same_maxima([g[k] for g in got], want)


def test_grey_dilation_matches_jax():
    rng = np.random.default_rng(1234)
    img = rng.normal(0, 1, (64, 64)).astype(np.float32)
    artificial.draw_feature(img, (32, 32), 2.0, signal=60.0)
    got = pl.grey_dilation(torch.from_numpy(img), 7, percentile=99.9,
                           max_features=16)
    _same_maxima(got, _jl().grey_dilation(img, 7, percentile=99.9,
                                          max_features=16))


@pytest.mark.parametrize("per_axis", [False, True])
@pytest.mark.parametrize("shape,window,radius", [
    ((2, 64, 64), (9, 9), (4.5, 4.5)),
    ((1, 24, 40, 40), (13, 9, 9), (6.5, 4.5, 4.5))])
def test_feature_sizes_match_jax(per_axis, shape, window, radius):
    rng = np.random.default_rng(4)
    st = rng.normal(5, 1, shape).astype(np.float32)
    D = len(shape) - 1
    coords = np.zeros((shape[0], 6, D), np.int32)
    for t in range(shape[0]):
        for k in range(6):
            p = np.array([rng.uniform(2, s - 3) for s in shape[1:]])
            artificial.draw_feature(st[t], p, 1.5 + 0.2 * k, 100.0)
            coords[t, k] = np.round(p)
    # a feature at the frame's corner: its window is clamped (a corner
    # window of noise alone is 0/0 here: a mass on one pixel has
    # rg² = m2 = 0 exactly, and either side returns its rounding)
    corner = np.array([1.3, 1.6, 2.2][:D])
    artificial.draw_feature(st[0], corner, 1.6, 100.0)
    coords[0, 0] = np.round(corner)
    valid = np.ones(coords.shape[:2], bool)
    valid[-1, -1] = False
    bg = np.median(st.reshape(shape[0], -1), axis=1).astype(np.float32)
    noise = np.full(shape[0], 1.0, np.float32)
    got = pl.feature_sizes(torch.from_numpy(st), torch.from_numpy(coords),
                           torch.from_numpy(valid), window, radius,
                           torch.from_numpy(bg), torch.from_numpy(noise),
                           per_axis=per_axis).numpy()
    want = np.asarray(_jl().feature_sizes(st, coords, valid, window, radius,
                                          bg, noise, per_axis=per_axis))
    np.testing.assert_allclose(got, want, rtol=SIZE_RTOL)


# --------------------------------------------------------------------------
# tests/test_locate.py's scenes
# --------------------------------------------------------------------------
def test_finds_isolated_features():
    img = np.zeros((64, 64), np.float32)
    truth = np.array([[10, 12], [30, 40], [50, 20]], float)
    for p in truth:
        artificial.draw_feature(img, p, 2.0, signal=100.0)
    got = pl.local_maxima(img, (5, 5), 8, 10.0)
    _same_maxima(got, _jl().local_maxima(img, (5, 5), max_features=8,
                                         threshold=10.0))
    coords = got[0].numpy()[got[2].numpy()]
    assert len(coords) == 3
    np.testing.assert_array_equal(
        coords[np.lexsort(coords.T[::-1])],
        truth[np.lexsort(truth.T[::-1])].astype(int))


def test_threshold_excludes_dim_features():
    img = np.zeros((64, 64), np.float32)
    artificial.draw_feature(img, (10, 10), 2.0, signal=100.0)
    artificial.draw_feature(img, (40, 40), 2.0, signal=5.0)
    got = pl.local_maxima(img, (5, 5), 8, 20.0)
    _same_maxima(got, _jl().local_maxima(img, (5, 5), 8, 20.0))
    assert int(got[2].sum()) == 1


def test_brightest_first_and_padding():
    img = np.zeros((32, 32), np.float32)
    artificial.draw_feature(img, (8, 8), 1.5, signal=50.0)
    artificial.draw_feature(img, (20, 20), 1.5, signal=150.0)
    got = pl.local_maxima(img, (5, 5), 4, 1.0)
    _same_maxima(got, _jl().local_maxima(img, (5, 5), 4, 1.0))
    vals = got[1].numpy()
    assert got[2].numpy().sum() == 2 and vals[0] > vals[1]
    assert tuple(got[0].numpy()[0]) == (20, 20)


def test_plateau_gives_single_maximum():
    img = np.zeros((32, 32), np.float32)
    img[10:12, 10:12] = 7.0
    got = pl.local_maxima(img, (5, 5), 4, 1.0)
    _same_maxima(got, _jl().local_maxima(img, (5, 5), 4, 1.0))
    assert int(got[2].sum()) == 1
    assert tuple(got[0].numpy()[0]) == (10, 10)   # the lowest flat index


def test_grey_dilation_percentile_threshold():
    rng = np.random.default_rng(1234)
    img = rng.normal(0, 1, (64, 64)).astype(np.float32)
    artificial.draw_feature(img, (32, 32), 2.0, signal=60.0)
    got = pl.grey_dilation(img, 7, percentile=99.9, max_features=16)
    _same_maxima(got, _jl().grey_dilation(img, 7, percentile=99.9,
                                          max_features=16))
    coords = got[0].numpy()[got[2].numpy()]
    assert any(abs(c[0] - 32) <= 1 and abs(c[1] - 32) <= 1 for c in coords)


def test_dense_frame_counts():
    img = np.zeros((128, 128), np.float32)
    truth = artificial.gen_nonoverlapping_locations(
        (128, 128), 40, separation=9, margin=6, rng=3)
    for p in truth:
        artificial.draw_feature(img, p, 2.0, signal=100.0)
    got = pl.local_maxima(img, (7, 7), 64, 20.0)
    _same_maxima(got, _jl().local_maxima(img, (7, 7), 64, 20.0))
    assert int(got[2].sum()) == len(truth)


def test_overflow_keeps_brightest():
    img = np.zeros((64, 64), np.float32)
    bright = [(56, 8 + 12 * k) for k in range(4)]
    for k in range(8):
        img[6, 6 + 7 * k] = 10.0
    for y, x in bright:
        img[y, x] = 100.0
    jl = _jl()
    got = pl.local_maxima(img, (5, 5), 4, 1.0)
    _same_maxima(got, jl.local_maxima(img, (5, 5), 4, 1.0))
    assert int(got[3]) == 12
    got = pl.local_maxima_topk(img, (5, 5), 4, 1.0)
    _same_maxima(got, jl.local_maxima_topk(img, (5, 5), 4, 1.0))
    assert {tuple(c) for c in got[0].numpy()[got[2].numpy()]} == set(bright)
    got = pl.grey_dilation(img, 5, max_features=4, threshold=1.0)
    _same_maxima(got, jl.grey_dilation(img, 5, max_features=4,
                                       threshold=1.0))
    assert {tuple(c) for c in got[0].numpy()[got[2].numpy()]} == set(bright)


def test_topk_matches_compaction_when_no_overflow():
    img = _peaks_frame()
    a = pl.local_maxima(img, (5, 5), 16, 10.0)
    b = pl.local_maxima_topk(img, (5, 5), 16, 10.0)
    _same_maxima(b, _jl().local_maxima_topk(img, (5, 5), 16, 10.0))
    ok = a[2].numpy()
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())
    np.testing.assert_array_equal(a[0].numpy()[ok], b[0].numpy()[ok])
    np.testing.assert_array_equal(a[1].numpy()[ok], b[1].numpy()[ok])


def test_pipeline_locate_threshold_modes():
    rng = np.random.default_rng(0)
    img = rng.normal(10.0, 2.0, (128, 128)).astype(np.float32)
    artificial.draw_feature(img, (40, 60), 2.0, signal=80.0)
    artificial.draw_feature(img, (90, 30), 2.0, signal=70.0)
    f, f_j = _locate_both(img, diameter=9, separation=5)
    _same_frame(f, f_j)
    assert len(f) == 2
    got = f[["y", "x"]].to_numpy().astype(int)
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                  [[40, 60], [90, 30]])
    thr = float(np.percentile(img, 64.0))
    f, f_j = _locate_both(img, diameter=9, separation=5, threshold=thr,
                          max_features=8192)
    _same_frame(f, f_j)
    assert len(f) > 50 and f["signal"].max() > 60.0
    # the same frame overflowing max_features: the brightest 20
    f, f_j = _locate_both(img, diameter=9, separation=5, threshold=thr,
                          max_features=20)
    _same_frame(f, f_j)
    assert len(f) == 20


def test_locate_size_estimate():
    rng = np.random.default_rng(5)
    for sigma in (1.3, 1.6, 2.2):
        img = np.zeros((128, 128), np.float32)
        for k in range(9):
            p = np.array([20.0 + 30 * (k // 3), 20.0 + 30 * (k % 3)])
            artificial.draw_feature(img, p + rng.uniform(-2, 2, 2), sigma,
                                    150.0)
        img += rng.normal(0, 2.0, img.shape).astype(np.float32)
        f, f_j = _locate_both(img, diameter=11, separation=(5, 5))
        _same_frame(f, f_j)
        est = f["size"].median()
        assert abs(est - sigma) < 0.12 * sigma + 0.05, (sigma, est)


def test_locate_size_estimate_3d_aniso():
    rng = np.random.default_rng(9)
    img = np.zeros((48, 96, 96), np.float32)
    true_sz = np.array([2.4, 1.4, 1.4])
    for k in range(8):
        p = np.array([24.0, 24.0 + 48 * (k // 4),
                      16.0 + 20 * (k % 4)]) + rng.uniform(-1.5, 1.5, 3)
        artificial.draw_feature(img, p, true_sz, 150.0)
    img += rng.normal(0, 1.0, img.shape).astype(np.float32)
    f, f_j = _locate_both(img, diameter=(13, 9, 9), separation=(7, 5, 5))
    _same_frame(f, f_j)
    assert {"size", "size_z", "size_y", "size_x"} <= set(f.columns)
    est = f[["size_z", "size_y", "size_x"]].median().to_numpy()
    assert est[0] > 1.3 * est[1], est
    assert np.all(np.abs(est - true_sz) < 0.35 * true_sz + 0.1), est


def test_gaussian_blur_noise_reduction():
    rng = np.random.default_rng(0)
    sigma = 1.6
    noise = rng.normal(0, 1.0, (1, 128, 128)).astype(np.float32)
    sm = pl.gaussian_blur(torch.from_numpy(noise), (sigma, sigma)).numpy()
    np.testing.assert_allclose(
        sm, np.asarray(_jl().gaussian_blur(noise, (sigma, sigma))),
        rtol=0, atol=FILTER_RTOL * np.abs(noise).max())
    expect = 1.0 / (2.0 * np.sqrt(np.pi) * sigma)
    assert abs(sm.std() / expect - 1.0) < 0.15, (sm.std(), expect)
    img = np.zeros((1, 64, 64), np.float32)
    artificial.draw_feature(img[0], (32.0, 32.0), sigma, 100.0)
    smf = pl.gaussian_blur(torch.from_numpy(img), (sigma, sigma)).numpy()
    assert abs(smf.max() / img.max() - 0.5) < 0.05


class _One:
    def __init__(self, img):
        self.img = img

    def __getitem__(self, t):
        return self.img

    def __len__(self):
        return 1


def test_locate_matched_filter_finds_subgate_feature():
    from clustertracking_tpu.pipeline import _locate_frames as jax_frames

    rng = np.random.default_rng(3)
    sigma = 1.6
    img = np.zeros((128, 128), np.float32)
    artificial.draw_feature(img, (64.0, 64.0), sigma, 8.0)
    img += rng.normal(0, 2.0, img.shape).astype(np.float32)
    kw = dict(diameter=9, locate_separation=(3, 3), threshold=None,
              percentile=64, max_features=64, t_column="frame")
    raw = _locate_frames(_One(img), [0], device="cpu", **kw)
    mf = _locate_frames(_One(img), [0], match_sigma=sigma, device="cpu",
                        **kw)
    _same_frame(raw, jax_frames(_One(img), [0], **kw))
    _same_frame(mf, jax_frames(_One(img), [0], match_sigma=sigma, **kw),
                scale=np.abs(img).max())

    def hit(f):
        return bool(len(f)) and float(
            np.hypot(f["y"] - 64.0, f["x"] - 64.0).min()) < 1.5

    assert hit(mf) and not hit(raw)
    d = np.hypot(mf["y"] - 64.0, mf["x"] - 64.0)
    assert 4.0 < float(mf.loc[d.idxmin(), "signal"]) < 14.0


def test_locate_polydisperse_sizes():
    img = np.zeros((256, 256), np.float32)
    rng = np.random.default_rng(7)
    truth_pos, truth_size = [], []
    k = 0
    for y in range(24, 232, 28):
        for x in range(24, 232, 28):
            pos = (y + rng.uniform(-2, 2), x + rng.uniform(-2, 2))
            size = 1.5 if k % 2 == 0 else 3.0
            artificial.draw_feature(img, pos, size, 200.0)
            truth_pos.append(pos)
            truth_size.append(size)
            k += 1
    img += rng.normal(0, 2.0, img.shape).astype(np.float32)
    f, f_j = _locate_both(img, diameter=15, separation=(9, 9),
                          max_features=256)
    _same_frame(f, f_j)
    d, j = cKDTree(np.asarray(truth_pos)).query(f[["y", "x"]].to_numpy(),
                                                k=1)
    ok = d < 2.0
    assert ok.sum() >= 0.9 * len(truth_pos), ok.sum()
    est = f["size"].to_numpy()[ok]
    true = np.asarray(truth_size)[j[ok]]
    assert 1.0 < float(np.median(est[true == 1.5])) < 2.0
    assert 2.4 < float(np.median(est[true == 3.0])) < 3.8


# --------------------------------------------------------------------------
# tests/test_locate_robust.py's scenes (those without track)
# --------------------------------------------------------------------------
def _vignetted_scene(seed=5, n_feat=24, signal=25.0, noise=2.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    r = np.sqrt((yy - 128.0) ** 2 + (xx - 128.0) ** 2)
    img = 100.0 * np.exp(-0.5 * (r / 70.0) ** 6)
    truth = []
    for _ in range(n_feat):
        pos = (float(rng.uniform(16, 240)), float(rng.uniform(16, 240)))
        artificial.draw_feature(img, pos, 1.6, signal)
        truth.append(pos)
    img += rng.normal(0, noise, img.shape).astype(np.float32)
    return img.astype(np.float32), np.asarray(truth)


def _score(f, truth, r=2.0):
    if not len(f):
        return 0, 0
    pos = f[["y", "x"]].to_numpy()
    d, _ = cKDTree(truth).query(pos, k=1)
    d2, _ = cKDTree(pos).query(truth, k=1)
    return int((d2 < r).sum()), int((d > r).sum())


def test_raw_locate_floods_on_vignette():
    img, truth = _vignetted_scene()
    f, f_j = _locate_both(img, diameter=9, separation=(5, 5),
                          max_features=4096)
    _same_frame(f, f_j)
    assert _score(f, truth)[1] > 10 * len(truth)


def test_bandpass_locate_rescues_vignette():
    img, truth = _vignetted_scene()
    f, f_j = _locate_both(img, diameter=9, separation=(5, 5),
                          max_features=4096, preprocess="bandpass")
    _same_frame(f, f_j, scale=np.abs(img).max())
    found, ghosts = _score(f, truth)
    assert found >= 0.9 * len(truth) and ghosts <= 0.2 * len(truth)


def test_tile_threshold_rescues_vignette():
    img, truth = _vignetted_scene()
    f, f_j = _locate_both(img, diameter=9, separation=(5, 5),
                          max_features=4096, threshold_tile=16)
    _same_frame(f, f_j)
    found, ghosts = _score(f, truth)
    assert found >= 0.9 * len(truth) and ghosts <= 0.2 * len(truth)


def _locate_and_refine(img8, truth, diameter, sep, csep, tol):
    import clustertracking_tpu as ct

    f, f_j = _locate_both(img8, diameter=diameter, separation=(sep, sep))
    _same_frame(f, f_j)
    f["frame"] = 0
    f = ctt.find_clusters(f, csep)
    out = refine_cpu(f, img8, diameter=diameter, separation=csep)
    out_j = ct.refine_leastsq(f, img8, diameter=diameter, separation=csep)
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               out_j[["y", "x"]].to_numpy(), atol=1e-3)
    ok = out[out["cost"].notna()]
    d, _ = cKDTree(np.asarray(truth)).query(ok[["y", "x"]].to_numpy(), k=1)
    assert (d < tol).all(), d
    return f, ok


def test_uint8_dtype_flows_through():
    img = np.zeros((96, 96), np.float32)
    truth = [(30.3, 40.6), (60.7, 25.2), (70.1, 70.9)]
    for p in truth:
        artificial.draw_feature(img, p, 1.8, 120.0)
    img8 = np.clip(img + 10.0, 0, 255).astype(np.uint8)
    f, ok = _locate_and_refine(img8, truth, 9, 5, 7, 0.1)
    assert len(f) == 3 and len(ok) == 3


def test_saturated_peaks_still_refine():
    img = np.zeros((96, 96), np.float32)
    truth = [(30.4, 40.7), (62.2, 28.6)]
    for p in truth:
        artificial.draw_feature(img, p, 2.0, 400.0)
    img += np.random.default_rng(2).normal(0, 1.0, img.shape).astype(
        np.float32)
    img8 = np.clip(img, 0, 255).astype(np.uint8)
    assert (img8 == 255).sum() >= 4
    _, ok = _locate_and_refine(img8, truth, 11, 7, 9, 0.3)
    assert len(ok) == 2


def test_locate_frames_of_differing_shapes_go_one_by_one():
    """A chunk of frames of two shapes: each frame is located alone, and
    gets the single-frame result."""
    a = np.random.default_rng(0).normal(10, 2, (64, 80)).astype(np.float32)
    b = np.random.default_rng(1).normal(10, 2, (72, 64)).astype(np.float32)
    artificial.draw_feature(a, (30, 30), 1.6, 80.0)
    artificial.draw_feature(b, (40, 20), 1.6, 80.0)

    class Two:
        def __getitem__(self, t):
            return (a, b)[t]

    kw = dict(diameter=9, locate_separation=(5, 5), threshold=None,
              percentile=64, max_features=64, t_column="frame")
    out = _locate_frames(Two(), [0, 1], device="cpu", **kw)
    for t, img in enumerate((a, b)):
        one = locate_cpu(img, diameter=9, separation=(5, 5),
                         max_features=64)
        got = out[out["frame"] == t].drop(columns=["frame"])
        pd.testing.assert_frame_equal(got.reset_index(drop=True), one)


def test_locate_refuses_unknown_preprocess():
    with pytest.raises(ValueError, match="preprocess"):
        locate_cpu(np.zeros((16, 16), np.float32), diameter=5,
                   preprocess="median")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"preprocess": "bandpass"},
                                {"preprocess": "bandpass",
                                 "threshold_tile": 64}])
def test_locate_on_the_card_matches_cpu(kw):
    """locate on CUDA against the same call on the CPU, on a 512² frame of
    Gaussian features in noise: the raw path candidate for candidate; the
    filtered paths on at least 99.9% of candidates (the tile map's
    upsampling is not the same code on the two devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    img = rng.normal(20.0, 2.0, (512, 512)).astype(np.float32)
    for p in rng.uniform(8, 504, (300, 2)):
        artificial.draw_feature(img, p, 1.6, float(rng.uniform(30, 150)))
    on_card = ctt.locate(img, diameter=9, separation=6, device="cuda", **kw)
    on_cpu = locate_cpu(img, diameter=9, separation=6, **kw)
    if not kw:
        _same_frame(on_card, on_cpu)
        return
    a = {tuple(p) for p in on_card[["y", "x"]].to_numpy()}
    b = {tuple(p) for p in on_cpu[["y", "x"]].to_numpy()}
    assert len(a ^ b) <= 0.001 * len(b), (len(a ^ b), len(b))
