"""The threshold statistics of ``pipeline._locate_frames``: every 4th pixel
along each axis, or every pixel of a frame whose strided sample would
hold fewer than ``_FULL_STATS_BELOW`` (4,096) pixels, that is 2D frames
under 256² and 3D frames under 64³.  The reference subsamples every frame
(its pipeline.py:1489-1493): on a 32² frame its floors come from 64
pixels.  ``_FULL_STATS_BELOW = None`` reproduces it.  Configs 2 and 5
(512², 1024²) take the strided sample either way.
"""
import functools

import numpy as np
import pytest
import torch

from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch import pipeline as tp

locate_frames = functools.partial(
    tp._locate_frames, diameter=7, locate_separation=(4, 4),
    percentile=64.0, max_features=256, t_column="frame", device="cpu")


@pytest.fixture
def stats_below():
    keep = tp._FULL_STATS_BELOW
    yield lambda v: setattr(tp, "_FULL_STATS_BELOW", v)
    tp._FULL_STATS_BELOW = keep


@pytest.mark.parametrize("shape,full", [
    ((32, 32), True), ((252, 256), True), ((256, 256), False),
    ((512, 512), False), ((16, 48, 48), True), ((64, 64, 64), False)])
def test_subsample_takes_every_pixel_of_small_frames(shape, full):
    x = torch.arange(2 * int(np.prod(shape)), dtype=torch.float32)
    x = x.reshape((2,) + shape)
    flat = tp._subsample(x, 2)
    strided = x[(slice(None),) + (slice(None, None, 4),) * len(shape)]
    want = x.reshape(2, -1) if full else strided.reshape(2, -1)
    assert torch.equal(flat, want)


def test_subsample_as_the_reference(stats_below):
    stats_below(None)
    x = torch.rand((3, 32, 32))
    assert torch.equal(tp._subsample(x, 3), x[:, ::4, ::4].reshape(3, -1))


def _frame():
    rng = np.random.default_rng(7)
    img = rng.normal(10.0, 2.0, (32, 32)).astype(np.float32)
    for p in ((8, 9), (20, 22), (25, 6)):
        artificial.draw_feature(img, p, 1.5, 60.0)
    for p in ((14, 27), (29, 15)):   # dim: above one threshold, not both
        artificial.draw_feature(img, p, 1.5, 17.0)
    img[::4, ::4] += 4.0   # the strided sample reads a brighter floor
    return img


def _threshold(sample):
    med = np.median(sample)
    mad = np.median(np.abs(sample - med))
    return max(float(np.percentile(sample, 64.0)), med + 6 * 1.4826 * mad)


@pytest.mark.parametrize("below,sample", [
    (4096, lambda img: img), (None, lambda img: img[::4, ::4])])
def test_small_frame_threshold_comes_from_its_sample(stats_below, below,
                                                     sample):
    """A 32² frame with its strided sample's pixels raised: the default
    threshold is the one of every pixel with the port's statistics and
    the one of the strided sample with the reference's, so the candidates
    equal those of that threshold given outright, and the two paths'
    candidates differ."""
    stats_below(below)
    img = _frame()

    class One:
        def __getitem__(self, t):
            return img

    cols = ["y", "x", "signal"]
    got = locate_frames(One(), [0], threshold=None)[cols]
    want = locate_frames(One(), [0], threshold=_threshold(sample(img)))[cols]
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    other = _threshold(img if below is None else img[::4, ::4])
    assert len(locate_frames(One(), [0], threshold=other)) != len(got)
