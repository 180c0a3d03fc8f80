"""The window gather: its plain version (``gather_stack``, which
``window_gather`` returns on the CPU) vs the reference's Pallas gather
kernel, and (on a card) the CUDA kernel vs the plain version.

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


@pytest.mark.cuda
@pytest.mark.parametrize("window,shape", [
    ((7, 9), (64, 256)),
    ((5, 11, 11), (16, 64, 128)),
    ((9, 13, 13), (64, 192, 192)),   # config 4
    ((3, 40, 37), (8, 50, 60)),      # rows wider than a warp
])
def test_window_gather_matches_plain_on_the_card(window, shape):
    """csrc/window_gather.cu vs gather_stack on the same CUDA tensors: bit
    for bit; a lane whose window lies outside the stack reads NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, fidx, origins = _case(window, shape, 40, seed=2)
    args = [torch.as_tensor(a).to("cuda") for a in (frames, fidx, origins)]
    before = window_gather.launches
    got = window_gather(*args, window)
    want = gather_stack(*args, window)
    torch.cuda.synchronize()
    assert window_gather.launches == before + 1
    assert torch.equal(got, want)
    args[1][0] = 3  # frame index past the stack
    got = window_gather(*args, window)
    assert torch.isnan(got[0]).all() and torch.equal(got[1:], want[1:])
