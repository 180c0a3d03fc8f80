"""The gathered route's LM: plain version vs the reference's Pallas
kernels, the kernel routing, the wrapper's refusals and mode choice, and
(on a card) kernel vs plain in both modes.

``pixel_lm_reference`` is held to ``make_pallas_lm(...,
fused_gather=False)``'s ``solve`` run as the JAX package's own tests run
it on the CPU (interpret mode): 2D; 3D in one pixel chunk; 3D in many
chunks (the center-out ctab order and the dead-chunk skip); and
streaming.  Scenes are config 4's (``example_batch_3d``, with noise) at B=4
on 32×48×48 stacks, and tests/test_pallas_lm.py's 2D dimers; max_iter=6.
Tolerances as tests/test_torch_fused_lm.py states them: positions and
sizes to 1e-4 px, signal to 1e-4 relative, npix and converged exactly,
n_iter exactly on lanes that did not converge (at convergence the plateau
exit moves with float32 rounding, ROADMAP queue 3).

JAX is imported inside the parity tests only, so that the card-only tests
run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_pixel_lm.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch.entry import (
    MODES_3D, RADIUS_3D, WINDOW_3D, example_batch_3d)
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.ops.fused_lm import (
    fused_lm_2d_reference, kernel_route)
from clustertracking_tpu_torch.ops.gather import gather_stack, origins_for
from clustertracking_tpu_torch.ops.pixel_lm import (
    check_pixel_lm_args, occupancy, pick_streaming, pixel_lm,
    pixel_lm_reference, smem_words)
from clustertracking_tpu_torch.refine import _slot_bounds

torch.set_num_threads(1)

MAX_IT = 6
ATOL = 1e-4
RTOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _scene_3d(window, B=4):
    """Config 4's dimers with noise (sigma 1 on signal 150), so that every
    fit's rms lies well above float32 resolution: on the noise-free scene a
    fit reaches rms ~1e-7 in four iterations, after which the plateau exit
    is decided by rounding."""
    frames, fidx, params0, _, _ = example_batch_3d(B=B, shape=(32, 48, 48))
    frames = frames + np.random.default_rng(7).normal(
        0.0, 1.0, frames.shape).astype(np.float32)
    lay = build_layout(get_model("gauss"), 3, False, 2, dict(MODES_3D))
    return lay, frames, fidx, params0, window, RADIUS_3D


def _scene_2d(B=4, seed=0):
    """tests/test_pallas_lm.py's 2D dimers (9×9 windows, radius 3)."""
    rng = np.random.default_rng(seed)
    lay = build_layout(get_model("gauss"), 2, True, 2, {})
    frames = np.zeros((B, 64, 64), np.float32)
    params0 = np.zeros((B, 2, lay.n_params), np.float32)
    for b in range(B):
        center = np.array([32.0, 32.0]) + rng.uniform(-1, 1, 2)
        true = artificial.draw_cluster(
            frames[b], center, size=1.8, separation=4.0, n=2, signal=100.0,
            angle=rng.uniform(0, np.pi))
        params0[b, :, 1] = 100.0
        params0[b, :, 2:4] = true + rng.uniform(-0.2, 0.2, true.shape)
        params0[b, :, 4] = 1.8
    return lay, frames, np.arange(B, dtype=np.int32), params0, (9, 9), \
        (3.0, 3.0)


def _inputs(lay, frames, fidx, params0, window, radius, valid):
    pos = params0[..., list(lay.pos_param_idx)].copy()
    origin = origins_for(_t(pos), window, frames.shape[1:])
    pixels = gather_stack(_t(frames), _t(fidx), origin, window)
    lo, hi = _slot_bounds(lay, window, frames.shape[1:])
    args = (lay.vect_from_params(_t(params0)), _t(params0), pixels,
            _t(pos), origin, _t(params0[..., 1].max(axis=1)), _t(valid),
            None)
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              lo=lo, hi=hi, radius=radius, max_iter=MAX_IT)
    return args, kw


def _pallas_solve(lay, args, kw, **make_kw):
    import jax.numpy as jnp

    from clustertracking_tpu.models import build_layout as jax_build_layout
    from clustertracking_tpu.models import get_model as jax_get_model
    from clustertracking_tpu.ops.pallas_lm import make_pallas_lm

    jlay = jax_build_layout(jax_get_model("gauss"), lay.ndim, lay.isotropic,
                            lay.n_features, dict(zip(lay.param_names,
                                                     lay.modes)))
    solve = make_pallas_lm(
        jax_get_model("gauss"), jlay, kw["window_shape"], kw["lo"], kw["hi"],
        kw["radius"], max_iter=MAX_IT, interpret=True, fused_gather=False,
        **make_kw)
    return solve(*[jnp.asarray(a.numpy()) for a in args[:7]])


@pytest.mark.parametrize("scene,window,make_kw", [
    ("2d", (9, 9), {}),
    ("3d", (5, 7, 7), {}),                         # one pixel chunk
    ("3d", (7, 9, 9), dict(chunk_len=128)),        # ctab, dead chunks
    ("3d", WINDOW_3D, dict(streaming=True)),       # kernel_stream
], ids=["2d", "3d_single_chunk", "3d_multi_chunk_ctab", "3d_streaming"])
def test_reference_matches_pallas_pixel_kernel(scene, window, make_kw):
    lay, frames, fidx, params0, _, radius = (
        _scene_2d() if scene == "2d" else _scene_3d(window))
    valid = np.array([True, True, False, True])
    args, kw = _inputs(lay, frames, fidx, params0, window, radius, valid)
    res = pixel_lm_reference(*args, **kw)
    jres = _pallas_solve(lay, args, kw, **make_kw)
    sig = [int(s) for s in lay.slot_idx[:, 1]]
    other = [s for s in range(lay.n_slots) if s not in sig]
    x, jx = res.x.numpy(), np.asarray(jres.x)
    np.testing.assert_allclose(x[:, other], jx[:, other], atol=ATOL, rtol=0)
    np.testing.assert_allclose(x[:, sig], jx[:, sig], rtol=RTOL, atol=0)
    conv = res.converged.numpy()
    np.testing.assert_array_equal(conv, np.asarray(jres.converged))
    running = ~conv
    np.testing.assert_array_equal(res.n_iter.numpy()[running],
                                  np.asarray(jres.n_iter)[running])
    np.testing.assert_array_equal(res.npix.numpy()[valid],
                                  np.asarray(jres.npix)[valid])
    assert (res.npix.numpy()[~valid] == 0).all()
    assert (res.cost.numpy()[~valid] == 0).all()
    assert (res.npix.numpy()[valid] > 0).all()


def test_wrapper_on_cpu_returns_the_plain_version():
    lay, frames, fidx, params0, window, radius = _scene_3d(WINDOW_3D)
    args, kw = _inputs(lay, frames, fidx, params0, window, radius,
                       np.ones(4, bool))
    before = (pixel_lm.launches_resident, pixel_lm.launches_streamed)
    for streaming in (None, True, False):
        out = pixel_lm(*args, **kw, streaming=streaming)
        for a, b in zip(out, pixel_lm_reference(*args, **kw)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (pixel_lm.launches_resident, pixel_lm.launches_streamed) == before


def test_fused_reference_is_gather_then_pixel_reference():
    lay, frames, fidx, params0, window, radius = _scene_2d()
    args, kw = _inputs(lay, frames, fidx, params0, window, radius,
                       np.ones(4, bool))
    fused = fused_lm_2d_reference(args[0], args[1], _t(frames), _t(fidx),
                                  *args[3:], **kw)
    for a, b in zip(fused, pixel_lm_reference(*args, **kw)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("ndim,window,modes,expect", [
    (2, (13, 13), {}, "fused"),               # config 1
    (2, (156, 156), {}, "fused"),             # 24,336 px: still fits
    (2, (161, 161), {}, "gathered"),          # past fused_lm_2d's cap
    (3, WINDOW_3D, dict(MODES_3D), "gathered"),   # config 4 (V = 14)
    (3, (5, 9, 9), {}, "gathered"),           # 3D isotropic
    (3, (80, 80, 80), {}, None),              # past the window cap
])
def test_kernel_route_names_the_route(ndim, window, modes, expect):
    """The fault of the first slice and its repair: every 3D bucket and
    every 2D window past fused_lm_2d's shared memory used to reach the
    fused kernel and raise on CUDA; they route to the gathered kernels."""
    isotropic = not modes
    lay = build_layout(get_model("gauss"), ndim, isotropic, 2, modes)
    assert kernel_route(get_model("gauss"), lay, False, None,
                        window) == expect


def test_mode_choice_against_the_measured_budget():
    """Shared memory per warp as csrc/pixel_lm.cu lays it out, and the rule
    streaming=None applies to the occupancy calculator's warps per SM.  On
    an H100 config 4's resident layout (20.5 KB per warp) holds 8 warps per
    SM against streamed's 16 (bound by registers), and streamed is the
    faster mode there, so it streams; at equal occupancy resident stays; a
    window whose resident warp fits no block streams."""
    assert smem_words(2, 0, True) == 1947   # fused_lm_2d.cu's core
    assert smem_words(3, 0, True) == 2075
    assert smem_words(3, 1521, False) == 2075 + 2 * 1521
    assert 4 * smem_words(3, 1521, False) == 20468   # bytes per warp
    assert pick_streaming({"resident": 8, "streamed": 16})
    assert not pick_streaming({"resident": 16, "streamed": 16})
    assert pick_streaming({"resident": 0, "streamed": 16})


def _checked_args():
    lay, frames, fidx, params0, window, radius = _scene_3d(WINDOW_3D)
    args, kw = _inputs(lay, frames, fidx, params0, window, radius,
                       np.ones(4, bool))
    args = list(args[:7]) + [torch.ones(4, 2)]
    return args, dict(model=kw["model"], layout=lay, window_shape=window)


def test_check_pixel_lm_args_accepts_config_4():
    args, kw = _checked_args()
    check_pixel_lm_args(*args, **kw)


@pytest.mark.parametrize("which,bad,err", [
    (2, lambda a: a.double(), TypeError),                 # pixels f64
    (2, lambda a: a[:, :-1].contiguous(), ValueError),    # pixels width
    (3, lambda a: a[..., :2].contiguous(), ValueError),   # pos_at 2D
    (4, lambda a: a.long(), TypeError),                   # origin i64
    (6, lambda a: a.float(), TypeError),                  # valid as f32
    (1, lambda a: a.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),                                         # not contiguous
])
def test_check_pixel_lm_args_refuses(which, bad, err):
    args, kw = _checked_args()
    args[which] = bad(args[which])
    with pytest.raises(err):
        check_pixel_lm_args(*args, **kw)


def _custom_model():
    """A Lorentzian given as a custom model dict (the gauss parameters)."""
    return get_model({"name": "lorentz", "params": [],
                      "fun": lambda r2: 1.0 / (1.0 + r2)})


def test_check_pixel_lm_args_refuses_profiles_without_a_kernel():
    """A custom model is a Python callable no kernel evaluates."""
    args, kw = _checked_args()
    kw["model"] = _custom_model()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 item 1"):
        check_pixel_lm_args(*args, **kw)


def test_wrapper_refuses_other_devices():
    lay, frames, fidx, params0, window, radius = _scene_3d(WINDOW_3D)
    args, kw = _inputs(lay, frames, fidx, params0, window, radius,
                       np.ones(4, bool))
    args = [a.to("meta") if a is not None else None for a in args]
    with pytest.raises(ValueError, match="device"):
        pixel_lm(*args, **kw)


def _agree(res_k, res_p, pos_slots):
    """Kernel vs plain on the card: positions 1e-3 px; cost 1e-3 relative
    except on lanes fit to float32 resolution (rms < 1e-5 of the signal
    scale in both, where the cost is rounding noise; chip_smoke.py's
    RMS_FLOOR); npix equal."""
    xk, xp = res_k.x.cpu().numpy(), res_p.x.cpu().numpy()
    np.testing.assert_allclose(xk[:, pos_slots], xp[:, pos_slots],
                               atol=1e-3, rtol=0)
    ck, cp = res_k.cost.cpu().numpy(), res_p.cost.cpu().numpy()
    nk = np.maximum(res_k.npix.cpu().numpy(), 1.0)
    rel = np.abs(ck - cp) / np.maximum(cp, 1e-30)
    floor = (np.sqrt(ck / nk) < 1e-5) & (np.sqrt(cp / nk) < 1e-5)
    assert ((rel <= 1e-3) | floor).all()
    np.testing.assert_array_equal(res_k.npix.cpu().numpy(),
                                  res_p.npix.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [False, True, None])
def test_kernel_matches_plain_on_the_card(streaming):
    """csrc/pixel_lm.cu vs pixel_lm_reference on config 4's first-round
    inputs (B=256, with frozen lanes), resident, streamed and chosen (by
    occupancy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, fidx, params0, _, _ = example_batch_3d(B=256)
    lay = build_layout(get_model("gauss"), 3, False, 2, dict(MODES_3D))
    valid = np.ones(256, bool)
    valid[::7] = False
    args, kw = _inputs(lay, frames, fidx, params0, WINDOW_3D, RADIUS_3D,
                       valid)
    args = [a.to("cuda") if a is not None else None for a in args]
    kw["max_iter"] = 60
    before = pixel_lm.launches_streamed
    res_k = pixel_lm(*args, **kw, streaming=streaming)
    res_p = pixel_lm_reference(*args, **kw)
    torch.cuda.synchronize()
    if streaming is None:
        streaming = pick_streaming(occupancy(WINDOW_3D))
    assert pixel_lm.launches_streamed == before + int(streaming)
    _agree(res_k, res_p, [2, 3, 4, 5, 6, 7])
    assert (res_k.cost.cpu().numpy()[~valid] == 0).all()
    with pytest.raises(NotImplementedError):
        pixel_lm(*args, **dict(kw, model=_custom_model()))


@pytest.mark.cuda
def test_streamed_2d_route_matches_plain_route_on_the_card():
    """A 161×161 bucket (past fused_lm_2d's shared memory) through the
    bucket solver: the streamed gathered route vs the plain route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clustertracking_tpu_torch.entry import example_batch
    from clustertracking_tpu_torch.refine import _bucket_solver

    batch = example_batch(B=128, frame_size=256, grid_pitch=16)
    args = [torch.as_tensor(a).to("cuda") for a in batch]
    common = (get_model("gauss"), 2, True, 2, (), (161, 161), (6.5, 6.5),
              (), None, 1e5, 10, 1.0, 60, 1.49e-8, 1.49e-8, False)
    kernel_solve, _ = _bucket_solver(*common, "auto")
    plain_solve, _ = _bucket_solver(*common, "torch", "torch")
    before = pixel_lm.launches_streamed
    pk, rk, ck, _, _ = kernel_solve(*args)
    pp, rp, cp, _, _ = plain_solve(*args)
    torch.cuda.synchronize()
    assert pixel_lm.launches_streamed > before
    np.testing.assert_allclose(pk.cpu().numpy()[..., 2:4],
                               pp.cpu().numpy()[..., 2:4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(rk.cpu().numpy(), rp.cpu().numpy(),
                               rtol=5e-4)  # rms; 1e-3 on cost
    np.testing.assert_array_equal(ck.cpu().numpy(), cp.cpu().numpy())
