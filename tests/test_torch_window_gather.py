"""The window gather: its plain version (``gather_stack``, which
``window_gather`` returns on the CPU) vs the reference's Pallas gather
kernel and vs numpy slicing, and (on a card) the CUDA kernel vs the plain
version.

``make_pallas_gather(..., tile_g=4, interpret=True)`` runs as the JAX
package's own tests run it on the CPU, on the cases of
tests/test_pallas_gather.py (2D and 3D, aligned and whole-width blocks,
corners straddling every alignment boundary).  A gather is a copy, so
every comparison is exact.

JAX is imported inside the parity tests only, so that the card-only tests
run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_window_gather.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from clustertracking_tpu_torch.ops.gather import gather_stack
from clustertracking_tpu_torch.ops.window_gather import window_gather


def _case(window, shape, B, seed=0):
    """tests/test_pallas_gather.py's inputs."""
    rng = np.random.default_rng(seed)
    T = 3
    frames = rng.normal(size=(T,) + shape).astype(np.float32)
    fidx = rng.integers(0, T, B).astype(np.int32)
    origins = np.stack(
        [rng.integers(0, shape[d] - window[d] + 1, B)
         for d in range(len(shape))],
        axis=1,
    ).astype(np.int32)
    return frames, fidx, origins


def _pallas(window, shape, frames, fidx, origins, tile_g):
    import jax.numpy as jnp

    from clustertracking_tpu.ops.pallas_gather import make_pallas_gather

    g = make_pallas_gather(window, shape, tile_g=tile_g, interpret=True)
    out = g(jnp.asarray(frames), jnp.asarray(fidx), jnp.asarray(origins))
    return np.asarray(out)[:int(np.prod(window)), :len(fidx)].T


def _port(window, frames, fidx, origins):
    args = (torch.as_tensor(frames), torch.as_tensor(fidx),
            torch.as_tensor(origins))
    before = window_gather.launches
    out = window_gather(*args, window)
    assert window_gather.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(out.numpy(),
                                  gather_stack(*args, window).numpy())
    return out.numpy()


@pytest.mark.parametrize("window,shape", [
    ((7, 9), (64, 256)),            # 2D, x-block mode
    ((7, 9), (64, 128)),            # 2D, whole-width block
    ((5, 11, 11), (16, 64, 256)),   # 3D, aligned
    ((5, 11, 11), (16, 64, 128)),   # 3D, whole-width block
])
def test_gather_matches_pallas_gather(window, shape):
    frames, fidx, origins = _case(window, shape, 24)
    np.testing.assert_array_equal(
        _port(window, frames, fidx, origins),
        _pallas(window, shape, frames, fidx, origins, tile_g=4))


def test_gather_boundary_corners_match_pallas_gather():
    """Origins that straddle the 8-row / 128-column alignment boundaries of
    the reference's DMA blocks."""
    window, shape = (9, 13), (64, 256)
    frames = np.random.default_rng(1).normal(
        size=(1,) + shape).astype(np.float32)
    origins = np.array(list(zip([0, 1, 7, 8, 55, 55],
                                [0, 115, 120, 127, 128, 243])), np.int32)
    fidx = np.zeros(len(origins), np.int32)
    got = _port(window, frames, fidx, origins)
    np.testing.assert_array_equal(
        got, _pallas(window, shape, frames, fidx, origins, tile_g=2))
    for i, (y, x) in enumerate(origins):
        np.testing.assert_array_equal(got[i].reshape(window),
                                      frames[0, y:y + 9, x:x + 13])


def test_window_gather_refuses_other_devices():
    frames, fidx, origins = _case((7, 9), (64, 128), 4)
    args = [torch.as_tensor(a).to("meta") for a in (frames, fidx, origins)]
    with pytest.raises(ValueError, match="device"):
        window_gather(*args, (7, 9))


def _gather_case(name, seed=2):
    """(frames, frame_idx, origin, window) of a named case, as numpy."""
    if name == "161x161":   # [stream2d]'s window
        frames, fidx, origins = _case((161, 161), (256, 256), 7, seed=3)
        return frames, fidx, origins, (161, 161)
    window, shape, B = {
        "2d": ((7, 9), (64, 256), 40),
        "3d_whole_width": ((5, 11, 11), (16, 64, 128), 40),
        "config4": ((9, 13, 13), (64, 192, 192), 40),
        "rows_wider_than_a_warp": ((3, 40, 37), (8, 50, 60), 40),
        "w_not_multiple_of_4": ((7, 9), (50, 59), 40),
        "large_3d_window": ((12, 40, 40), (24, 128, 128), 9),
        "B1": ((9, 13, 13), (64, 192, 192), 1),
        "B_odd": ((9, 13, 13), (64, 192, 192), 41),
    }[name]
    frames, fidx, origins = _case(window, shape, B, seed=seed)
    return frames, fidx, origins, window


def _offset_view(frames, offset, device):
    """``frames`` as a view ``offset`` floats into a larger buffer."""
    t = torch.as_tensor(frames).to(device)
    if not offset:
        return t
    buf = torch.zeros(frames.size + offset, device=device)
    buf[offset:] = t.reshape(-1)
    view = buf[offset:].view(frames.shape)
    assert view.storage_offset() == offset
    return view


CASES = ["2d", "3d_whole_width", "config4", "rows_wider_than_a_warp",
         "w_not_multiple_of_4", "161x161", "large_3d_window", "B1", "B_odd",
         "offset_aligned", "offset_misaligned"]
OFFSETS = {"offset_aligned": 4, "offset_misaligned": 1}


@pytest.mark.parametrize("case", CASES)
def test_window_gather_on_the_cpu_is_the_numpy_slice(case):
    """On CPU tensors window_gather is gather_stack, launches nothing, and
    returns each cluster's window as numpy slices it, in raster order."""
    offset = OFFSETS.get(case)
    frames, fidx, origins, window = _gather_case(
        "config4" if offset else case)
    args = [_offset_view(frames, offset, "cpu"), torch.as_tensor(fidx),
            torch.as_tensor(origins)]
    before = window_gather.launches
    out = window_gather(*args, window)
    assert window_gather.launches == before
    assert torch.equal(out, gather_stack(*args, window))
    for b, (t, o) in enumerate(zip(fidx, origins)):
        want = frames[(t,) + tuple(slice(s, s + w)
                                   for s, w in zip(o, window))]
        np.testing.assert_array_equal(out[b].numpy(), want.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_window_gather_matches_plain_on_the_card(case):
    """csrc/window_gather.cu vs gather_stack on the same CUDA tensors: bit
    for bit; lanes whose frame index or window lies outside the stack
    read NaN; the counter counts the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    offset = OFFSETS.get(case)
    frames, fidx, origins, window = _gather_case(
        "config4" if offset else case)
    args = [_offset_view(frames, offset, "cuda")] + [
        torch.as_tensor(a).to("cuda") for a in (fidx, origins)]
    before = window_gather.launches
    got = window_gather(*args, window)
    want = gather_stack(*args, window)
    torch.cuda.synchronize()
    assert window_gather.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)
    B = len(fidx)
    args[1][0] = frames.shape[0]            # frame index past the stack
    if B > 1:
        args[2][B - 1, 0] = -1              # a window that starts outside
    got = window_gather(*args, window)
    torch.cuda.synchronize()
    bad = [0] + ([B - 1] if B > 1 else [])
    assert torch.isnan(got[bad]).all()
    keep = [b for b in range(B) if b not in bad]
    assert torch.equal(got[keep], want[keep])


@pytest.mark.cuda
def test_window_gather_every_lane_outside_the_stack_on_the_card():
    """A batch in which no lane is inside the stack: every row NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, fidx, origins, window = _gather_case("B_odd")
    frames = torch.as_tensor(frames).to("cuda")
    fidx = torch.full((len(fidx),), frames.shape[0], dtype=torch.int32,
                      device="cuda")
    out = window_gather(frames, fidx, torch.as_tensor(origins).to("cuda"),
                        window)
    torch.cuda.synchronize()
    assert out.shape == (len(fidx), 1521) and torch.isnan(out).all()


@pytest.mark.cuda
def test_window_gather_empty_batch_on_the_card():
    """B=0 returns an empty [0, Npix] and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, _, _ = _case((9, 13, 13), (64, 192, 192), 1)
    frames = torch.as_tensor(frames).to("cuda")
    fidx = torch.zeros((0,), dtype=torch.int32, device="cuda")
    origin = torch.zeros((0, 3), dtype=torch.int32, device="cuda")
    before = window_gather.launches
    out = window_gather(frames, fidx, origin, (9, 13, 13))
    assert out.shape == (0, 1521) and out.device.type == "cuda"
    assert window_gather.launches == before
