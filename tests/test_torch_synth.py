"""Frame rendering in the port (``ops/synth.py``), held to the JAX package
on the same numpy feature tables, with the port on the CPU.

The cases are tests/test_synth.py's four, each with the reference's own
assertion on the port's result, and:

- the port's frames within 1e-4 × the largest signal of JAX's (float32
  on both sides, summed in another order: JAX adds each pixel's
  contributions one by one in float32, the port sums them in float64);
- noise held by its statistics (mean within 4 standard errors of 0, std
  within 2% of the level), since JAX's random stream is not PyTorch's;
- two renders of one table bit-equal, and the render independent of the
  order of the table's rows up to the float64 sum's rounding.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch.ops.synth import frames_from_df, render_frames

torch.set_num_threads(1)

SIGNAL_RTOL = 1e-4


def _jax_synth():
    from clustertracking_tpu.ops import synth

    return synth


def _coords_df(T=3, n_per=5, shape=(48, 64), seed=0):
    """tests/test_synth.py::_coords_df."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(T):
        pos = artificial.gen_random_locations(shape, n_per, margin=6, rng=rng)
        for p in pos:
            rows.append({"y": p[0], "x": p[1],
                         "signal": rng.uniform(50, 150), "frame": t})
    return pd.DataFrame(rows)


def _close(out, ref, signal):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0,
                               atol=SIGNAL_RTOL * signal)


def test_frames_match_coordinate_reader():
    """tests/test_synth.py::test_frames_match_coordinate_reader."""
    shape = (48, 64)
    f = _coords_df(shape=shape)
    stack = frames_from_df(f, shape, 2.0, device="cpu")
    assert stack.shape == (3,) + shape and stack.dtype == torch.float32
    _close(stack, _jax_synth().frames_from_df(f, shape, 2.0),
           f["signal"].max())
    reader = artificial.CoordinateReader(f, shape, 2.0)
    for t in range(3):
        assert np.max(np.abs(stack[t].numpy() - reader[t])) < 1e-3


def test_edge_features_do_not_corrupt_frame():
    """tests/test_synth.py::test_edge_features_do_not_corrupt_frame."""
    shape = (32, 32)
    f = pd.DataFrame({"y": [1.0, 30.5], "x": [0.5, 31.0],
                      "signal": [100.0, 80.0], "frame": [0, 0]})
    ref = artificial.draw_spots(shape, f[["y", "x"]].to_numpy(), 2.0,
                                f["signal"].to_numpy())
    dev = frames_from_df(f, shape, 2.0, device="cpu")[0]
    assert np.max(np.abs(dev.numpy() - ref)) < 1e-3
    _close(dev, _jax_synth().frames_from_df(f, shape, 2.0)[0], 100.0)


@pytest.mark.parametrize("prof", ["gauss", "disc", "ring"])
def test_render_frames_profiles(prof):
    """tests/test_synth.py::test_render_frames_profiles_and_noise, the
    profiles."""
    pos = np.array([[16.0, 16.0]], np.float32)
    sig = np.array([100.0], np.float32)
    sz = np.array([[3.0, 3.0]], np.float32)
    fidx = np.array([0], np.int32)
    extras = (np.array([0.2], np.float32),) if prof == "ring" else ()
    img = render_frames(pos, sig, sz, fidx, 1, (32, 32), fit_function=prof,
                        window=(31, 31), extras=extras, device="cpu")[0]
    _close(img, _jax_synth().render_frames(
        pos, sig, sz, fidx, 1, (32, 32), fit_function=prof, window=(31, 31),
        extras=extras)[0], 100.0)
    host = np.zeros((32, 32))
    artificial.draw_feature(
        host, (16, 16), 3.0, 100.0, feat_func=prof, cutoff_sigmas=5.0,
        **({"thickness": 0.2} if prof == "ring" else {}))
    assert np.max(np.abs(img.numpy() - host)) < 1e-2


def test_render_frames_noise():
    """tests/test_synth.py::test_render_frames_profiles_and_noise, the
    noise: its statistics against the level (the values are PyTorch's
    generator's, not JAX's), seeded and repeatable."""
    pos = np.array([[16.0, 16.0]], np.float32)
    sig = np.array([100.0], np.float32)
    sz = np.array([[3.0, 3.0]], np.float32)
    fidx = np.array([0], np.int32)
    kw = dict(window=(31, 31), device="cpu")
    clean = render_frames(pos, sig, sz, fidx, 1, (256, 256), **kw)
    noisy = render_frames(pos, sig, sz, fidx, 1, (256, 256),
                          noise_level=2.0, seed=3, **kw)
    resid = (noisy - clean).numpy()
    assert 1.0 < resid.std() < 3.0
    assert abs(resid.std() - 2.0) < 0.02 * 2.0
    assert abs(resid.mean()) < 4 * 2.0 / np.sqrt(resid.size)
    again = render_frames(pos, sig, sz, fidx, 1, (256, 256),
                          noise_level=2.0, seed=3, **kw)
    assert torch.equal(noisy, again)
    other = render_frames(pos, sig, sz, fidx, 1, (256, 256),
                          noise_level=2.0, seed=4, **kw)
    assert not torch.equal(noisy, other)
    ref = np.asarray(_jax_synth().render_frames(
        pos, sig, sz, fidx, 1, (256, 256), window=(31, 31), noise_level=2.0,
        seed=3))
    ref_resid = ref - clean.numpy()
    assert abs(resid.std() - ref_resid.std()) < 0.02 * 2.0


def test_render_then_refine_recovers_truth():
    """tests/test_synth.py::test_render_then_refine_recovers_truth, the
    port's render through the port's refine_leastsq."""
    shape = (64, 64)
    f = pd.DataFrame({
        "y": [20.0, 24.0, 44.5], "x": [30.0, 33.0, 14.25],
        "signal": [120.0, 110.0, 90.0], "frame": [0, 0, 0],
    })
    frames = frames_from_df(f, shape, 2.0, device="cpu")
    _close(frames, _jax_synth().frames_from_df(f, shape, 2.0), 120.0)
    f0 = f.copy()
    f0[["y", "x"]] += np.random.default_rng(0).uniform(-0.4, 0.4, (3, 2))
    out = ctt.refine_leastsq(f0, frames[0].numpy(), diameter=9,
                             separation=7, param_val={"size": 2.0},
                             param_mode={"size": "const"}, device="cpu")
    got = out[["y", "x"]].to_numpy()
    assert np.abs(got - f[["y", "x"]].to_numpy()).max() < 0.01


def test_dense_render_is_repeatable_and_matches_reference():
    """A crowded table (2,000 overlapping features, anisotropic sizes, on
    two frames): within the tolerance of JAX's frames, bit-equal between
    two renders, and equal to the render of the table's rows reversed up
    to the float64 sum's rounding."""
    rng = np.random.default_rng(5)
    N = 2000
    pos = rng.uniform(-4, 68, (N, 2)).astype(np.float32)
    sig = rng.uniform(50, 150, N).astype(np.float32)
    sz = rng.uniform(1.0, 2.0, (N, 2)).astype(np.float32)
    fidx = rng.integers(0, 2, N).astype(np.int32)
    args = (2, (64, 64))
    kw = dict(window=(24, 24))
    out = render_frames(pos, sig, sz, fidx, *args, device="cpu", **kw)
    _close(out, _jax_synth().render_frames(pos, sig, sz, fidx, *args, **kw),
           150.0)
    assert torch.equal(out, render_frames(pos, sig, sz, fidx, *args,
                                          device="cpu", **kw))
    rev = render_frames(pos[::-1], sig[::-1], sz[::-1], fidx[::-1], *args,
                        device="cpu", **kw)
    np.testing.assert_allclose(rev.numpy(), out.numpy(), rtol=1e-6,
                               atol=1e-6 * 150.0)


def test_render_needs_a_device():
    """With no ``device`` the render runs on CUDA and, where there is
    none, raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        frames_from_df(_coords_df(), (48, 64), 2.0)


@pytest.mark.cuda
def test_render_on_the_card_matches_cpu():
    """frames_from_df on CUDA against the CPU (1e-4 × signal) and two
    renders on the card bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = _coords_df(T=4, n_per=400, shape=(256, 256))
    card = frames_from_df(f, (256, 256), 1.6, device="cuda")
    assert torch.equal(card, frames_from_df(f, (256, 256), 1.6,
                                            device="cuda"))
    _close(card.cpu(), frames_from_df(f, (256, 256), 1.6, device="cpu"),
           f["signal"].max())
