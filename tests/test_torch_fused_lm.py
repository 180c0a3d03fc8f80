"""The fused LM route: plain version vs the reference's Pallas kernel, the
wrapper's routing and refusals, and (on a card) kernel vs plain.

``fused_lm_2d_reference`` is held to ``make_pallas_lm(...,
fused_gather=True)`` run as the JAX package's own tests run it on the CPU
(interpret mode), on tests/test_pallas_lm.py's scene: B=4 dimers, 9×9
windows, max_iter=6, 64×128 frames.  Positions agree to 1e-4 px, signal
and size to 1e-4 relative, background to 1e-4 of the signal scale (the
same algorithm, float32, sums in another order), npix exactly, n_iter and
converged exactly.

JAX is imported inside the parity tests only, so that the card-only test
runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_fused_lm.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch.entry import example_batch
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.ops.fused_lm import (
    check_kernel_args, fused_lm_2d, fused_lm_2d_reference, kernel_mask)
from clustertracking_tpu_torch.ops.gather import origins_for, radius_mask
from clustertracking_tpu_torch.refine import _slot_bounds, kernel_route

torch.set_num_threads(1)

WINDOW = (9, 9)
RADIUS = (3.0, 3.0)
MAX_IT = 6
POS_ATOL = 1e-4
RTOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _scene(n, modes, B=4, seed=0):
    """tests/test_pallas_lm.py's fused-gather scene (frames padded to a
    128-multiple width, content unchanged)."""
    rng = np.random.default_rng(seed)
    lay = build_layout(get_model("gauss"), 2, True, n, modes)
    frames = np.zeros((B, 64, 64), np.float32)
    params0 = np.zeros((B, n, lay.n_params), np.float32)
    for b in range(B):
        center = np.array([32.0, 32.0]) + rng.uniform(-1, 1, 2)
        true = artificial.draw_cluster(
            frames[b], center, size=1.8, separation=4.0, n=n, signal=100.0,
            angle=rng.uniform(0, np.pi),
        )
        params0[b, :, 1] = 100.0
        params0[b, :, 2:4] = true + rng.uniform(-0.2, 0.2, true.shape)
        params0[b, :, 4] = 1.8
    frames = np.pad(frames, ((0, 0), (0, 0), (0, 64)))
    fidx = np.arange(B, dtype=np.int32)
    pos0 = params0[..., 2:4].copy()
    origin = origins_for(_t(pos0), WINDOW, frames.shape[1:]).numpy()
    norm = params0[..., 1].max(axis=1)
    bounds = _slot_bounds(lay, WINDOW, frames.shape[1:])
    return lay, frames, fidx, params0, pos0, origin, norm, bounds


def _run_both(n, modes, valid):
    import jax.numpy as jnp

    from clustertracking_tpu.models import build_layout as jax_build_layout
    from clustertracking_tpu.models import get_model as jax_get_model
    from clustertracking_tpu.ops.pallas_lm import make_pallas_lm

    lay, frames, fidx, params0, pos0, origin, norm, bounds = _scene(n, modes)
    jlay = jax_build_layout(jax_get_model("gauss"), 2, True, n, modes)
    vect0 = jlay.vect_from_params(jnp.asarray(params0))
    psolve = make_pallas_lm(
        jax_get_model("gauss"), jlay, WINDOW, bounds.lo.numpy(),
        bounds.hi.numpy(), RADIUS,
        max_iter=MAX_IT, interpret=True, fused_gather=True,
        frame_shape=frames.shape[1:],
    )
    assert psolve.fused_gather
    jres = psolve(vect0, jnp.asarray(params0), jnp.asarray(frames),
                  jnp.asarray(fidx), jnp.asarray(pos0), jnp.asarray(origin),
                  jnp.asarray(norm), jnp.asarray(valid))
    args = (lay.vect_from_params(_t(params0)), _t(params0), _t(frames),
            _t(fidx), _t(pos0), _t(origin), _t(norm), _t(valid), None)
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=WINDOW,
              bounds=bounds, radius=RADIUS, max_iter=MAX_IT)
    return lay, fused_lm_2d_reference(*args, **kw), jres, args, kw


@pytest.mark.parametrize("n,modes,valid", [
    (2, {}, [True, True, True, True]),
    (2, {}, [True, False, True, False]),
    (1, {"size": "var", "background": "cluster"}, [True] * 4),
])
def test_reference_matches_pallas_fused_kernel(n, modes, valid):
    valid = np.array(valid)
    lay, res, jres, _, _ = _run_both(n, modes, valid)
    pos = sorted({int(s) for p in lay.pos_param_idx
                  for s in lay.slot_idx[:, p]})
    bg = [int(lay.slot_idx[0, 0])] if lay.slot_idx[0, 0] >= 0 else []
    other = [s for s in range(lay.n_slots) if s not in pos + bg]
    x, jx = res.x.numpy(), np.asarray(jres.x)
    np.testing.assert_allclose(x[:, pos], jx[:, pos], atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(x[:, other], jx[:, other], rtol=RTOL, atol=0)
    # the background's own value is ~0 here: it is held to 1e-4 of the
    # signal scale (100), the scale the residual is normalized by
    np.testing.assert_allclose(x[:, bg], jx[:, bg], rtol=0, atol=RTOL * 100)
    np.testing.assert_array_equal(res.n_iter.numpy(),
                                  np.asarray(jres.n_iter))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    # npix exactly, on the lanes the solve ran (a frozen lane reports 0
    # here; the reference kernel reports its mask inside an active tile)
    np.testing.assert_array_equal(res.npix.numpy()[valid],
                                  np.asarray(jres.npix)[valid])
    assert (res.npix.numpy()[~valid] == 0).all()
    assert (res.cost.numpy()[~valid] == 0).all()


def test_wrapper_on_cpu_returns_the_plain_version():
    valid = np.ones(4, bool)
    lay, res, _, args, kw = _run_both(2, {}, valid)
    before = fused_lm_2d.launches
    out = fused_lm_2d(*args, **kw)
    assert fused_lm_2d.launches == before  # no kernel launched on the CPU
    for a, b in zip(out, res):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _kernel_args(B=4, n=2):
    lay, frames, fidx, params0, pos0, origin, norm, bounds = _scene(n, {})
    args = [lay.vect_from_params(_t(params0)), _t(params0), _t(frames),
            _t(fidx), _t(pos0), _t(origin), _t(norm),
            torch.ones(B, dtype=torch.bool), torch.ones(B, n)]
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=WINDOW,
              bounds=bounds)
    return args, kw


def test_check_kernel_args_accepts_the_main_path():
    args, kw = _kernel_args()
    check_kernel_args(*args, **kw)


@pytest.mark.parametrize("which,bad,err", [
    (2, lambda a: a.double(), TypeError),                 # frames f64
    (3, lambda a: a.long(), TypeError),                   # frame_idx i64
    (4, lambda a: torch.zeros(4, 2, 3), ValueError),      # pos_at 3D
    (1, lambda a: a.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),                                         # not contiguous
    (7, lambda a: a.float(), TypeError),                  # valid as f32
    (0, lambda a: a[:3], ValueError),                     # vect0 rows
])
def test_check_kernel_args_refuses(which, bad, err):
    args, kw = _kernel_args()
    args[which] = bad(args[which])
    with pytest.raises(err):
        check_kernel_args(*args, **kw)


def _custom_model():
    """A Lorentzian given as a custom model dict (the gauss parameters)."""
    return get_model({"name": "lorentz", "params": [],
                      "fun": lambda r2: 1.0 / (1.0 + r2)})


def test_check_kernel_args_refuses_profiles_without_a_kernel():
    """A custom model is a Python callable no kernel evaluates."""
    args, kw = _kernel_args()
    kw["model"] = _custom_model()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_kernel_args(*args, **kw)


def test_check_kernel_args_refuses_3d_windows():
    """3D buckets take the gathered route (window_gather, pixel_lm)."""
    args, kw = _kernel_args()
    kw["window_shape"] = (5, 9, 9)
    kw["layout"] = build_layout(get_model("gauss"), 3, True, 2, {})
    with pytest.raises(ValueError, match="gathered route"):
        check_kernel_args(*args, **kw)


def test_wrapper_refuses_other_devices():
    args, kw = _kernel_args()
    args = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="device"):
        fused_lm_2d(*args, **kw, radius=RADIUS)


@pytest.mark.parametrize("n,modes,use_global,window,expect", [
    (2, {}, False, (13, 13), "fused"),
    (6, {}, False, (24, 24), "fused"),               # V = 18
    (8, {}, False, (32, 32), "block"),               # V = 24 >= 20
    (40, {}, False, (228, 228), "block"),            # V = 120: config 5's
    (43, {}, False, (228, 228), None),               # V = 129: past the cap
    (8, {}, False, (600, 600), None),                # past the window cap
    (2, {}, True, (13, 13), "tied"),                 # tied, V = 9
    (8, {}, True, (32, 32), None),                   # tied, V = 24
    (2, {}, False, (600, 600), None),                # past the window cap
    (2, {"signal": "const", "y": "const", "x": "const"}, False, (13, 13),
     None),                                          # nothing to fit
])
def test_kernel_available_routing(n, modes, use_global, window, expect):
    """kernel_route (which replaced kernel_available) on 2D buckets."""
    lay = build_layout(get_model("gauss"), 2, True, n, modes)
    assert kernel_route(get_model("gauss"), lay, use_global, None,
                        window) == expect


def test_kernel_available_refuses_constraints():
    lay = build_layout(get_model("gauss"), 2, True, 2, {})
    assert kernel_route(get_model("gauss"), lay, False, object(),
                        (13, 13)) is None


def test_kernel_mask_matches_radius_mask_on_the_fixtures():
    """The kernel's mask ((off − rel)·(1/r)) and radius_mask (/ r), in
    both packages, on the main-path fixture: npix agrees on every lane."""
    import jax.numpy as jnp

    from clustertracking_tpu.ops.gather import radius_mask as jax_radius_mask

    frames, fidx, params0, pose0, valid = example_batch(B=256,
                                                        frame_size=128)
    pos = params0[..., 2:4]
    origin = origins_for(_t(pos), (13, 13), (128, 128))
    fv = torch.ones(256, 2)
    km = kernel_mask(_t(pos), origin, (13, 13), (4.5, 4.5), fv)
    rm = radius_mask(_t(pos), origin, (13, 13), (4.5, 4.5), fvalid=fv)
    jm = jax_radius_mask(jnp.asarray(pos), jnp.asarray(origin.numpy()),
                         (13, 13), (4.5, 4.5))
    np.testing.assert_array_equal(km.numpy(), rm.numpy())
    np.testing.assert_array_equal(km.numpy(), np.asarray(jm))


# The edges of the kernels' design (csrc/lm_core.cuh): a slot count at each
# ceiling of the register instantiations (8, 10, 14) and one past it, and
# the least and most the kernels take (1, 19); an in-mask pixel count of 0,
# 1, 31, 32 and 33 (a warp's 32 lanes, four pixels to a lane) and the whole
# window; one feature; a padded feature (fvalid 0); a window row wider than
# a warp.  id -> (n, modes, window, radius, the positions' fraction of a
# pixel or None for draw_cluster's own, fvalid of the last feature).
EDGE_CASES = {
    "V1": (1, {"y": "const", "x": "const"}, (9, 9), 3.0, None, 1.0),
    "V8": (2, {"size": "var"}, (9, 9), 3.0, None, 1.0),
    "V9": (2, {"size": "var", "background": "cluster"}, (9, 9), 3.0, None,
           1.0),
    "V10": (3, {"background": "cluster"}, (11, 11), 3.0, None, 1.0),
    "V11": (3, {"background": "cluster", "size": "cluster"}, (11, 11), 3.0,
            None, 1.0),
    "V14": (4, {"background": "cluster", "size": "cluster"}, (13, 13), 3.0,
            None, 1.0),
    "V15": (5, {}, (13, 13), 3.0, None, 1.0),
    "V19": (6, {"background": "cluster"}, (15, 15), 3.0, None, 1.0),
    "npix0": (1, {"y": "const", "x": "const"}, (9, 9), 0.3, (0.0, 0.5), 1.0),
    "npix1": (1, {"y": "const", "x": "const"}, (9, 9), 0.3, (0.0, 0.0), 1.0),
    "npix31": (1, {}, (9, 9), 3.2, (0.25, 0.25), 1.0),
    "npix32": (1, {}, (9, 9), 3.1, (0.0, 0.25), 1.0),
    "npix33": (1, {}, (9, 9), 3.25, (0.0, 0.25), 1.0),
    "whole_window": (1, {}, (9, 9), 20.0, (0.0, 0.0), 1.0),
    "padded_feature": (2, {}, (9, 9), 3.0, None, 0.0),
    "wide_row": (2, {}, (5, 40), 3.0, None, 1.0),
}
EDGE_NPIX = {"npix0": 0, "npix1": 1, "npix31": 31, "npix32": 32,
             "npix33": 33, "whole_window": 81}


def edge_case_inputs(case, B=4, seed=3):
    """The fused solve's arguments for an EDGE_CASES entry, on the CPU:
    clusters of n Gaussians (signal 100, size 1.8, separation 4) near the
    centre of 64×128 frames with noise sigma 1, starts ±0.2 px off."""
    n, modes, window, radius, frac, fv_last = EDGE_CASES[case]
    rng = np.random.default_rng(seed)
    lay = build_layout(get_model("gauss"), 2, True, n, modes)
    frames = np.zeros((B, 64, 128), np.float32)
    params0 = np.zeros((B, n, lay.n_params), np.float32)
    for b in range(B):
        center = np.array([32.0, 40.0])
        if frac is None:
            center = center + rng.uniform(-1, 1, 2)
        true = artificial.draw_cluster(
            frames[b], center, size=1.8, separation=4.0, n=n, signal=100.0,
            angle=rng.uniform(0, np.pi))
        params0[b, :, 1] = 100.0
        params0[b, :, 2:4] = true + rng.uniform(-0.2, 0.2, true.shape)
        if frac is not None:   # the gather-time position fixes the mask
            params0[b, :, 2:4] = center + np.asarray(frac)
        params0[b, :, 4] = 1.8
    frames += rng.normal(0.0, 1.0, frames.shape).astype(np.float32)
    pos0 = params0[..., 2:4].copy()
    origin = origins_for(_t(pos0), window, frames.shape[1:])
    bounds = _slot_bounds(lay, window, frames.shape[1:])
    fvalid = torch.ones(B, n)
    fvalid[:, -1] = fv_last
    args = (lay.vect_from_params(_t(params0)), _t(params0), _t(frames),
            _t(np.arange(B, dtype=np.int32)), _t(pos0), origin,
            _t(params0[..., 1].max(axis=1)), torch.ones(B, dtype=torch.bool),
            fvalid)
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              bounds=bounds, radius=(radius, radius), max_iter=MAX_IT)
    return lay, args, kw


def jax_lm_on_window(lay, args, kw):
    """The reference's ``lm_solve`` on the same window pixels and the same
    fit mask as the port's plain version (2D isotropic gauss layouts)."""
    import jax.numpy as jnp

    from clustertracking_tpu.models import build_layout as jax_build_layout
    from clustertracking_tpu.models import get_model as jax_get_model
    from clustertracking_tpu.ops.lm import lm_solve as jax_lm_solve
    from clustertracking_tpu.ops.residual import make_model_fns as jax_fns
    from clustertracking_tpu_torch.ops.gather import gather_stack

    vect0, params0, frames, fidx, pos0, origin, norm, valid, fvalid = args
    window = kw["window_shape"]
    jlay = jax_build_layout(jax_get_model("gauss"), 2, True, lay.n_features,
                            dict(zip(lay.param_names, lay.modes)))
    fns = jax_fns(jax_get_model("gauss"), jlay, window)
    pixels = gather_stack(frames, fidx, origin, window)
    mask = kernel_mask(pos0, origin, window, kw["radius"], fvalid)
    return jax_lm_solve(
        fns.residual, fns.residual_jac, jnp.asarray(vect0.numpy()),
        tuple(jnp.asarray(a.numpy()) for a in (
            params0, pixels, mask, origin, norm, fvalid)),
        max_iter=kw["max_iter"], lower=jnp.asarray(kw["bounds"].lo.numpy()),
        upper=jnp.asarray(kw["bounds"].hi.numpy()),
        valid=jnp.asarray(valid.numpy()))


def assert_edge_results_close(case, lay, res, ref, atol, rtol):
    """Positions within ``atol`` px, the other slots and the cost within
    ``rtol`` (relative; the background, ~0, within rtol of the signal
    scale), npix as the case fixes it."""
    pos = sorted({int(s) for p in lay.pos_param_idx
                  for s in lay.slot_idx[:, p] if s >= 0})
    bg = [int(lay.slot_idx[0, 0])] if lay.slot_idx[0, 0] >= 0 else []
    other = [s for s in range(lay.n_slots) if s not in pos + bg]
    x = res.x.cpu().numpy()
    rx = np.asarray(ref.x.cpu() if hasattr(ref.x, "cpu") else ref.x)
    np.testing.assert_allclose(x[:, pos], rx[:, pos], atol=atol, rtol=0)
    np.testing.assert_allclose(x[:, other], rx[:, other], rtol=rtol, atol=0)
    np.testing.assert_allclose(x[:, bg], rx[:, bg], rtol=0, atol=rtol * 100)
    rcost = np.asarray(ref.cost.cpu() if hasattr(ref.cost, "cpu")
                       else ref.cost)
    np.testing.assert_allclose(res.cost.cpu().numpy(), rcost, rtol=rtol,
                               atol=1e-12)
    if case in EDGE_NPIX:
        assert (res.npix.cpu().numpy() == EDGE_NPIX[case]).all()


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_reference_matches_jax_at_the_design_edges(case):
    """``fused_lm_2d_reference`` vs the reference's ``lm_solve`` on every
    EDGE_CASES entry (6 iterations): positions 1e-4 px, the other slots
    and the cost 1e-4 relative, n_iter and converged equal."""
    lay, args, kw = edge_case_inputs(case)
    res = fused_lm_2d_reference(*args, **kw)
    jres = jax_lm_on_window(lay, args, kw)
    assert_edge_results_close(case, lay, res, jres, POS_ATOL, RTOL)
    np.testing.assert_array_equal(res.n_iter.numpy(), np.asarray(jres.n_iter))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_kernel_matches_plain_at_the_design_edges_on_the_card(case):
    """csrc/fused_lm_2d.cu vs ``fused_lm_2d_reference`` on every EDGE_CASES
    entry, 60 iterations: positions 1e-3 px, the other slots and the cost
    1e-3 relative, npix exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lay, args, kw = edge_case_inputs(case, B=64)
    args = [a.to("cuda") for a in args]
    kw.update(max_iter=60, bounds=kw["bounds"].to("cuda"))
    before = fused_lm_2d.launches
    res_k = fused_lm_2d(*args, **kw)
    res_p = fused_lm_2d_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fused_lm_2d.launches == before + 1
    assert_edge_results_close(case, lay, res_k, res_p, 1e-3, 1e-3)
    np.testing.assert_array_equal(res_k.npix.cpu().numpy(),
                                  res_p.npix.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(13, 13), (41, 41)])
def test_kernel_matches_plain_on_the_card(window):
    """csrc/fused_lm_2d.cu vs fused_lm_2d_reference on the same CUDA
    tensors (main-path fixture): positions 1e-3 px, cost 1e-3 relative,
    npix exactly.  A 41×41 window needs more than 48 KB of shared memory
    per block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, fidx, params0, pose0, valid = example_batch(B=512,
                                                        frame_size=128)
    lay = build_layout(get_model("gauss"), 2, True, 2, {})
    dev = "cuda"
    p0 = _t(params0).to(dev)
    pos = p0[..., 2:4].contiguous()
    origin = origins_for(pos, window, (128, 128))
    bounds = _slot_bounds(lay, window, (128, 128), device=dev)
    args = (lay.vect_from_params(p0), p0, _t(frames).to(dev),
            _t(fidx).to(dev), pos, origin, p0[..., 1].amax(dim=1),
            _t(valid).to(dev), None)
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              bounds=bounds, radius=(4.5, 4.5), max_iter=60)
    before = fused_lm_2d.launches
    res_k = fused_lm_2d(*args, **kw)
    res_p = fused_lm_2d_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fused_lm_2d.launches == before + 1
    pos_slots = [2, 3, 4, 5]
    np.testing.assert_allclose(res_k.x.cpu().numpy()[:, pos_slots],
                               res_p.x.cpu().numpy()[:, pos_slots],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(res_k.cost.cpu().numpy(),
                               res_p.cost.cpu().numpy(), rtol=1e-3)
    np.testing.assert_array_equal(res_k.npix.cpu().numpy(),
                                  res_p.npix.cpu().numpy())
    with pytest.raises(NotImplementedError):
        fused_lm_2d(*args, **dict(kw, model=_custom_model()))


@pytest.mark.cuda
def test_bucket_solver_kernel_route_matches_plain_route_on_the_card():
    """The whole bucket solver on the card, kernel route ('auto') vs plain
    route ('torch'), on a batch whose starts are off by up to 1.2 px (so
    some lanes take a second refit round, where most lanes are frozen) and
    whose last lanes are padding (valid False).  The kernel route runs
    every round in one looped launch: the device counter of rounds past
    the first moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clustertracking_tpu_torch.diagnostics import refit_rounds
    from clustertracking_tpu_torch.refine import _bucket_solver

    frames, fidx, params0, pose0, valid = example_batch(B=512,
                                                        frame_size=128)
    rng = np.random.default_rng(11)
    params0 = params0.copy()
    params0[..., 2:4] += rng.uniform(-0.9, 0.9, params0[..., 2:4].shape)
    valid = valid.copy()
    valid[-20:] = False
    dev = "cuda"
    args = [torch.as_tensor(a).to(dev)
            for a in (frames, fidx, params0, pose0, valid)]
    common = (get_model("gauss"), 2, True, 2, (), (13, 13), (4.5, 4.5), (),
              None, 1e5, 10, 1.0, 60, 1.49e-8, 1.49e-8, False)
    kernel_route, _ = _bucket_solver(*common, "auto")
    plain_route, _ = _bucket_solver(*common, "torch")
    before = fused_lm_2d.launches, fused_lm_2d.launches_looped
    refits = refit_rounds()
    pk, rk, ck, ik, _ = kernel_route(*args)
    pp, rp, cp, ip, _ = plain_route(*args)
    torch.cuda.synchronize()
    assert (fused_lm_2d.launches, fused_lm_2d.launches_looped) == (
        before[0] + 1, before[1] + 1)
    assert refit_rounds() > refits  # a second refit round ran
    v = valid
    np.testing.assert_allclose(pk.cpu().numpy()[v][..., 2:4],
                               pp.cpu().numpy()[v][..., 2:4], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(rk.cpu().numpy()[v], rp.cpu().numpy()[v],
                               rtol=1e-3)
    np.testing.assert_array_equal(ck.cpu().numpy()[v], cp.cpu().numpy()[v])
    # padding lanes keep their start and report no fit
    np.testing.assert_array_equal(pk.cpu().numpy()[~v], params0[~v])
    assert np.isinf(rk.cpu().numpy()[~v]).all()
    assert (ik.cpu().numpy()[~v] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("isotropic", [True, False])
def test_refine_leastsq_kernel_route_matches_plain_route_on_the_card(
        isotropic):
    """refine_leastsq on the card through the kernel ('auto') and through
    lm_solve ('torch'): clusters of 1, 2, 3 and 5 features, so ladder
    buckets carry inert pad features (n=5 → 6) through the kernel's fvalid
    gating, with cluster-shared sizes.  Anisotropic, the n=6 bucket has
    V = 20 slots and is routed to the block kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pandas as pd

    from clustertracking_tpu_torch import diagnostics, refine_leastsq

    rng = np.random.default_rng(8)
    frames = np.zeros((2, 96, 128))
    rows = []
    for t in range(2):
        for n, c in zip((1, 2, 3, 5), [(20, 20), (20, 90), (70, 30),
                                       (65, 90)]):
            true = artificial.draw_cluster(
                frames[t], np.asarray(c, float), size=2.2, separation=4.5,
                n=n, signal=140.0, angle=rng.uniform(0, np.pi))
            for p in true + rng.uniform(-0.3, 0.3, true.shape):
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 140.0})
    frames += rng.normal(0.0, 1.0, frames.shape)
    f = pd.DataFrame(rows)
    if isotropic:
        size_cols, routes = ["size"], {"cuda-fused"}
        kw = dict(param_mode={"size": "cluster"}, param_val={"size": 2.2})
    else:
        size_cols, routes = ["size_y", "size_x"], {"cuda-fused",
                                                   "cuda-block"}
        f["size_y"], f["size_x"] = 2.2, 2.2
        kw = dict(param_mode={"size_y": "cluster", "size_x": "cluster"})
    kw.update(diameter=9, separation=5.5, device="cuda")
    with diagnostics.collect() as stats:
        out_k = refine_leastsq(f, frames, **kw)
    out_p = refine_leastsq(f, frames, lm_backend="torch", **kw)
    assert {b.backend for b in stats.batches} == routes
    assert sorted(b.cluster_size for b in stats.batches) == [1, 2, 3, 6]
    cols = ["y", "x"] + size_cols
    np.testing.assert_allclose(out_k[cols].to_numpy(),
                               out_p[cols].to_numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(out_k["cost"].to_numpy(),
                               out_p["cost"].to_numpy(), rtol=1e-3)
    np.testing.assert_array_equal(out_k["fit_converged"].to_numpy(),
                                  out_p["fit_converged"].to_numpy())
    assert out_k["cost"].notna().all()


@pytest.mark.cuda
def test_refine_leastsq_fitted_background_bounds_and_edges_on_the_card():
    """Kernel route vs plain route on the card for the kernel's remaining
    paths: a fitted (cluster-shared) background, per-feature sizes, a
    finite user bound on signal, and windows clamped at the frame edges
    (the edge cluster needs ~140 LM iterations, hence lm_max_iter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pandas as pd

    from clustertracking_tpu_torch import diagnostics, refine_leastsq

    rng = np.random.default_rng(9)
    frames = np.full((1, 64, 96), 5.0)
    rows = []
    for n, c in zip((1, 2, 2, 1), [(3.0, 4.0), (60.0, 50.0), (30.0, 93.0),
                                   (32.0, 40.0)]):
        true = artificial.draw_cluster(
            frames[0], np.asarray(c), size=2.0, separation=4.0, n=n,
            signal=150.0, angle=rng.uniform(0, np.pi))
        for p in np.clip(true + rng.uniform(-0.3, 0.3, true.shape), 0,
                         [63, 95]):
            rows.append({"frame": 0, "y": p[0], "x": p[1], "signal": 150.0,
                         "size": 2.0})
    frames += rng.normal(0.0, 1.0, frames.shape)
    f = pd.DataFrame(rows)
    kw = dict(diameter=9, separation=5.0, device="cuda", lm_max_iter=400,
              param_mode={"size": "var", "background": "cluster"},
              bounds={"signal": (0.0, 400.0)})
    with diagnostics.collect() as stats:
        out_k = refine_leastsq(f, frames, **kw)
    out_p = refine_leastsq(f, frames, lm_backend="torch", **kw)
    assert {b.backend for b in stats.batches} == {"cuda-fused"}
    assert out_k["fit_converged"].all()
    np.testing.assert_allclose(out_k[["y", "x", "size"]].to_numpy(),
                               out_p[["y", "x", "size"]].to_numpy(),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(out_k[["signal", "background"]].to_numpy(),
                               out_p[["signal", "background"]].to_numpy(),
                               rtol=0, atol=1e-3 * 150.0)
    np.testing.assert_allclose(out_k["cost"].to_numpy(),
                               out_p["cost"].to_numpy(), rtol=1e-3)
    np.testing.assert_array_equal(out_k["fit_converged"].to_numpy(),
                                  out_p["fit_converged"].to_numpy())


# ---------------------------------------------------------------------------
# The refit loop (``rounds``): the kernel runs every refit round of the
# bucket solver inside its launch; ``refit_on_host`` is its plain version,
# the host loop around one solve a round.  On the CPU the plain loop is
# held bit for bit to the bucket solver's own host loop, and the constants
# the solve builds once a device to the code that built them every call;
# on a card the kernel's loop is held to the host loop over the kernel's
# single solve, and a bucket's solve is run with PyTorch's sync debug mode
# set to raise.

REFIT_WINDOW = (13, 13)
REFIT_RADIUS = (4.5, 4.5)


def _refit_scene(kind, B, lm_iter, seed=5):
    """(constraint, layout, model, wrapper args [vect0, params0, frames,
    frame_idx, norm, valid], frame shape, bucket solver configuration) of
    a refit scene: 'dimer2d' (``entry.example_batch``), 'shifted' (the
    same with starts off by up to ±1.5 px, and every fourth cluster moved
    whole by up to ±6 px, so that lanes take one to three rounds),
    'ngon_dimer' / 'ngon_trimer' (config 3's rigid scenes,
    ``entry.example_batch_rigid``, noise σ=1, every fourth cluster's start
    moved whole by up to ±6 px) and 'disc' (dimers of the disc profile
    with noise σ=0.5, starts ±1.5 px).  The last two lanes are padding
    (valid False)."""
    from clustertracking_tpu_torch.constraints import (
        dimer, positions_to_pose, trimer)
    from clustertracking_tpu_torch.entry import example_batch_rigid
    from clustertracking_tpu_torch.ops.rigid import make_constrained_fns

    rng = np.random.default_rng(seed)
    con, window, radius, name = None, REFIT_WINDOW, REFIT_RADIUS, "gauss"
    if kind in ("dimer2d", "shifted"):
        frames, fidx, params0, pose0, valid = example_batch(
            B=B, frame_size=128, seed=seed)
        if kind == "shifted":
            params0[..., 2:4] += rng.uniform(-1.5, 1.5,
                                             params0[..., 2:4].shape)
            params0[::4, :, 2:4] += rng.uniform(-6.0, 6.0, (-(-B // 4), 1,
                                                             2))
    elif kind.startswith("ngon"):
        config = "3-dimer" if kind == "ngon_dimer" else "3-trimer"
        con = dimer(5.0, 2) if kind == "ngon_dimer" else trimer(5.0, 2)
        window = (15, 15) if kind == "ngon_dimer" else (17, 17)
        frames, fidx, params0, pose0, valid = example_batch_rigid(
            config, B=B, seed=seed)
        frames = frames + rng.normal(0, 1.0, frames.shape).astype(
            np.float32)
        params0[::4, :, 2:4] += rng.uniform(-6.0, 6.0, (-(-B // 4), 1, 2))
        pose0 = positions_to_pose(params0[:, :, 2:4], con).astype(
            np.float32)
    else:
        name = "disc"
        frames = np.zeros((-(-B // 64), 128, 128), np.float32)
        params0 = np.zeros((B, 2, 5), np.float32)
        fidx = np.zeros(B, np.int32)
        for b in range(B):
            t, cell = b // 64, b % 64
            center = (np.array([cell // 8, cell % 8]) * 16 + 8.0
                      + rng.uniform(-1, 1, 2))
            true = artificial.draw_cluster(
                frames[t], center, size=2.5, separation=5.0, n=2,
                signal=150.0, angle=rng.uniform(0, np.pi), feat_func="disc")
            params0[b, :, 1] = 150.0
            params0[b, :, 2:4] = true + rng.uniform(-1.5, 1.5, true.shape)
            params0[b, :, 4] = 2.5
            fidx[b] = t
        frames += rng.normal(0, 0.5, frames.shape).astype(np.float32)
        pose0 = np.zeros((B, 0), np.float32)
        valid = np.ones(B, bool)
    valid = valid.copy()
    valid[-2:] = False
    model = get_model(name)
    n = params0.shape[1]
    lay = build_layout(model, 2, True, n, {})
    p0 = _t(params0)
    if con is None:
        vect0 = lay.vect_from_params(p0)
    else:
        vect0 = make_constrained_fns(model, lay, window, con).vect_of(
            p0, _t(pose0))
    norm = torch.clamp(torch.amax(torch.abs(p0[..., 1]), dim=1), min=1e-6)
    args = [vect0, p0, _t(frames), _t(fidx), norm, _t(valid)]
    config = (model, 2, True, n, (), window, radius, (), con, 1e5, 10, 1.0,
              lm_iter, 1.49e-8, 1.49e-8, False)
    return con, lay, model, args, tuple(frames.shape[1:]), config, pose0


def _refit_kw(con, lay, model, frame_shape, config, device):
    window = config[5]
    return dict(model=model, layout=lay, window_shape=window,
                bounds=_slot_bounds(lay, window, frame_shape, (), con,
                                    device),
                radius=config[6], max_iter=config[12], constraint=con)


def _counting(solve):
    """``solve`` that keeps, a call, the lanes it solves."""
    def call(*args, **kw):
        call.lanes.append(args[7].clone())
        return solve(*args, **kw)
    call.lanes = []
    return call


def test_shape_constants_are_built_once_a_device_and_match():
    """The constants a solve used to copy to the device every round —
    ``vect_to_params``' slot index and const mask, ``origins_for`` /
    ``clamp_origins``' window and frame extents, the n-gon's angles and
    base vertices, the window offsets — are built once a device and kept:
    the same tensor object on a second call, equal to what the uncached
    code built, and the results of the functions that use them equal to
    the uncached formulas on the CPU."""
    from clustertracking_tpu_torch.constraints import (
        pose_to_positions, tetramer, trimer)
    from clustertracking_tpu_torch.ops.gather import (
        clamp_origins, shape_tensor)
    from clustertracking_tpu_torch.ops.residual import window_offsets

    cpu = torch.device("cpu")
    lay = build_layout(get_model("gauss"), 2, False, 3,
                       {"size_y": "cluster", "background": "cluster",
                        "signal": "const"})
    idx, is_const = lay.unpack_index(cpu)
    assert lay.unpack_index("cpu")[0] is idx
    np.testing.assert_array_equal(
        idx.numpy(), np.maximum(lay.slot_idx, 0).reshape(-1))
    np.testing.assert_array_equal(is_const.numpy(), lay.slot_idx < 0)
    rng = np.random.default_rng(0)
    vect = torch.as_tensor(rng.normal(size=(5, lay.n_slots)), dtype=torch.float32)
    params = torch.as_tensor(rng.normal(size=(5, 3, lay.n_params)),
                             dtype=torch.float32)
    want = torch.where(torch.as_tensor(lay.slot_idx < 0), params,
                       vect[..., torch.as_tensor(np.maximum(
                           lay.slot_idx, 0).reshape(-1))].reshape(5, 3, -1))
    got = lay.vect_to_params(vect, params)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    pos_idx = list(lay.pos_param_idx)
    p0 = pos_idx[0]
    np.testing.assert_array_equal(got[..., p0:p0 + 2].numpy(),
                                  got[..., pos_idx].numpy())

    # origins: half-integer centres (round half to even), edges, NaN
    pos = torch.as_tensor(rng.uniform(-5, 70, (64, 3, 2)),
                          dtype=torch.float32)
    pos[:8] = torch.round(pos[:8] * 2) / 2
    pos[8, 0, 0] = torch.nan
    for window, frame in (((13, 13), (64, 48)), ((9, 12), (30, 70))):
        w = torch.as_tensor(window, dtype=torch.float32)
        center = 0.5 * (torch.amin(pos, dim=1) + torch.amax(pos, dim=1))
        raw = torch.round(center - 0.5 * (w - 1.0)).to(torch.int32)
        maxi = torch.as_tensor([f - s for f, s in zip(frame, window)],
                               dtype=torch.int32)
        want = torch.minimum(torch.clamp(raw, min=0), maxi)
        np.testing.assert_array_equal(
            origins_for(pos, window, frame).numpy(), want.numpy())
        np.testing.assert_array_equal(
            clamp_origins(raw, window, frame).numpy(), want.numpy())
    assert shape_tensor((13, 13), torch.float32, "cpu") is shape_tensor(
        [13, 13], torch.float32, cpu)
    offs = window_offsets((4, 5), torch.float32, "cpu")
    assert window_offsets([4, 5], torch.float32, cpu) is offs
    grid = np.meshgrid(np.arange(4), np.arange(5), indexing="ij")
    np.testing.assert_array_equal(
        offs.numpy(), np.stack([g.ravel() for g in grid]))

    # the pose maps' constants
    for con, Q in ((trimer(5.0, 2), 3), (tetramer(3.2), 6)):
        pose = torch.as_tensor(rng.normal(size=(7, Q)), dtype=torch.float32)
        got = pose_to_positions(pose, con)
        n, D = con.cluster_size, con.ndim
        if D == 2:
            ang = pose[:, 2:3] + torch.as_tensor(
                2 * np.pi * np.arange(n) / n, dtype=torch.float32)[None]
            offs = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
        else:
            from clustertracking_tpu_torch.constraints import (
                _rodrigues, base_vertices)
            base = torch.as_tensor(base_vertices(n, D), dtype=torch.float32)
            offs = torch.einsum("bij,nj->bni", _rodrigues(pose[:, 3:6]),
                                base)
        from clustertracking_tpu_torch.constraints import (
            circumradius_factor)
        dist = torch.full((7,), con.dist, dtype=torch.float32)
        want = pose[:, None, :D] + (circumradius_factor(n, D) * dist)[
            :, None, None] * offs
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_fused_route_on_the_cpu_runs_the_host_loop(monkeypatch):
    """On the CPU, ``lm_backend='kernel'``'s fused route keeps the host
    loop: its route record runs no rounds on the device (``refit`` None,
    no ``refit`` in the span's args) and the solver calls the wrapper's
    single solve once a round, the later rounds on the lanes that still
    need one."""
    from clustertracking_tpu_torch import refine as refine_mod
    from clustertracking_tpu_torch.refine import _bucket_solver, _shard_solver

    con, lay, model, args, frame_shape, config, pose0 = _refit_scene(
        "shifted", 16, 20)
    route = _shard_solver(*config, "kernel")[3](torch.device("cpu"))
    assert route.taken == "fused" and route.refit is None
    assert route.span_args == {"route": "fused"}
    counted = _counting(refine_mod.fused_lm_2d)
    monkeypatch.setattr(refine_mod, "fused_lm_2d", counted)
    solve, _ = _bucket_solver(*config, "kernel")
    vect0, p0, frames, fidx, norm, valid = args
    solve(frames, fidx, p0, _t(pose0), valid)
    assert len(counted.lanes) >= 2
    assert torch.equal(counted.lanes[0], valid)
    assert 0 < int(counted.lanes[1].sum()) < int(valid.sum())


def test_refit_wrapper_refuses_mixed_positions():
    """``rounds`` and ``pos_at`` / ``origin`` exclude each other, and the
    loop takes at least one round."""
    args, kw = _kernel_args()
    with pytest.raises(ValueError, match="pos_at and origin as None"):
        check_kernel_args(*args, rounds=3, **kw)
    none = list(args)
    none[4] = none[5] = None
    with pytest.raises(ValueError, match="needs pos_at and origin"):
        check_kernel_args(*none, **kw)
    with pytest.raises(ValueError, match="at least 1"):
        check_kernel_args(*none, rounds=0, **kw)
    check_kernel_args(*none, rounds=1, **kw)


@pytest.mark.parametrize("kind", ["shifted", "ngon_dimer", "disc"])
def test_plain_refit_loop_is_the_bucket_solvers_host_loop(kind):
    """``fused_lm_2d_reference(rounds=...)`` (``refit_on_host`` around the
    plain single solve) gives the bucket solver's results on the CPU bit
    for bit: params, rms, converged and iterations of every lane, the
    padding lanes at their start with rms inf."""
    from clustertracking_tpu_torch.ops.rigid import make_constrained_fns
    from clustertracking_tpu_torch.refine import _bucket_solver

    con, lay, model, args, frame_shape, config, pose0 = _refit_scene(
        kind, 12, 20)
    vect0, p0, frames, fidx, norm, valid = args
    solve, _ = _bucket_solver(*config, "kernel")
    params, rms, conv, iters, _ = solve(frames, fidx, p0, _t(pose0), valid)
    kw = _refit_kw(con, lay, model, frame_shape, config, "cpu")
    res = fused_lm_2d_reference(vect0, p0, frames, fidx, None, None, norm,
                                valid, None, rounds=config[10],
                                max_shift=config[11], **kw)
    got = (lay.vect_to_params(res.x, p0) if con is None else
           make_constrained_fns(model, lay, config[5], con).params_of(
               res.x, p0))
    np.testing.assert_array_equal(got.numpy(), params.numpy())
    np.testing.assert_array_equal(res.rms.numpy(), rms.numpy())
    np.testing.assert_array_equal(res.converged.numpy(), conv.numpy())
    np.testing.assert_array_equal(res.n_iter.numpy(), iters.numpy())
    v = valid.numpy()
    assert np.isinf(res.rms.numpy()[~v]).all()
    np.testing.assert_array_equal(res.x.numpy()[~v], vect0.numpy()[~v])
    assert (res.n_iter.numpy()[v] > 0).all()
    # the wrapper on CPU tensors is the plain version
    out = fused_lm_2d(vect0, p0, frames, fidx, None, None, norm, valid,
                      None, rounds=config[10], max_shift=config[11], **kw)
    for a, b in zip(out, res):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _on_card(args):
    return [a.to("cuda") for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dimer2d", "shifted", "ngon_dimer",
                                  "ngon_trimer", "disc"])
def test_kernel_refit_loop_matches_the_host_loop_on_the_card(kind):
    """The kernel's refit loop (``rounds``) against the host loop over the
    same kernel's single solve (``refit_on_host``), 60 LM iterations, 10
    rounds.  Unconstrained lanes: x, rms, converged and the summed
    iterations bit-equal (so each lane ran the same rounds: every solved
    round adds at least one iteration to a sum of bit-equal rounds).
    Rigid lanes, whose positions the kernel takes from its own pose map:
    pose 1e-3, rms 1e-3 relative and converged on ≥ 99.9% of lanes, as
    test_torch_rigid_lm.py holds the rigid kernel to its plain version.
    The device counter moves by the host loop's rounds past the first;
    the launch counts one looped launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clustertracking_tpu_torch.diagnostics import refit_rounds
    from clustertracking_tpu_torch.ops.fused_lm import refit_on_host

    con, lay, model, args, frame_shape, config, _ = _refit_scene(
        kind, 2048, 60)
    vect0, p0, frames, fidx, norm, valid = _on_card(args)
    kw = _refit_kw(con, lay, model, frame_shape, config, "cuda")
    rounds, max_shift = config[10], config[11]
    counted = _counting(fused_lm_2d)
    host = refit_on_host(counted, vect0, p0, frames, fidx, norm, valid,
                         None, rounds=rounds, max_shift=max_shift, **kw)
    torch.cuda.synchronize()
    past_first = sum(int(lanes.sum()) for lanes in counted.lanes[1:])
    before = (refit_rounds(), fused_lm_2d.launches,
              fused_lm_2d.launches_looped)
    res = fused_lm_2d(vect0, p0, frames, fidx, None, None, norm, valid,
                      None, rounds=rounds, max_shift=max_shift, **kw)
    after = (refit_rounds(), fused_lm_2d.launches,
             fused_lm_2d.launches_looped)
    assert after[0] - before[0] == past_first
    assert after[1:] == (before[1] + 1, before[2] + 1)
    if kind != "dimer2d":
        assert past_first > 0
    if kind == "shifted":
        assert len(counted.lanes) >= 3
    xk, xh = res.x.cpu().numpy(), host.x.cpu().numpy()
    if con is None:
        np.testing.assert_array_equal(xk, xh)
        np.testing.assert_array_equal(res.rms.cpu().numpy(),
                                      host.rms.cpu().numpy())
        np.testing.assert_array_equal(res.converged.cpu().numpy(),
                                      host.converged.cpu().numpy())
        np.testing.assert_array_equal(res.n_iter.cpu().numpy(),
                                      host.n_iter.cpu().numpy())
        np.testing.assert_array_equal(res.npix.cpu().numpy(),
                                      host.npix.cpu().numpy())
        np.testing.assert_array_equal(res.cost.cpu().numpy(),
                                      host.cost.cpu().numpy())
    else:
        Qt = 3
        np.testing.assert_allclose(xk[:, :Qt], xh[:, :Qt], atol=1e-3,
                                   rtol=0)
        np.testing.assert_allclose(res.rms.cpu().numpy(),
                                   host.rms.cpu().numpy(), rtol=1e-3)
        assert np.mean(res.converged.cpu().numpy()
                       == host.converged.cpu().numpy()) >= 0.999
    v = valid.cpu().numpy()
    assert np.isinf(res.rms.cpu().numpy()[~v]).all()
    np.testing.assert_array_equal(xk[~v], vect0.cpu().numpy()[~v])
    print(f"[{kind}] rounds past the first: {past_first} over "
          f"{int(v.sum())} lanes (device counter "
          f"{after[0] - before[0]}), host loop {len(counted.lanes)} "
          "launches")


@pytest.mark.cuda
def test_a_fused_bucket_solve_makes_no_host_sync_on_the_card(monkeypatch):
    """A warm call of ``entry(device)``'s solver and a warm fused bucket of
    ``refine_leastsq`` run under ``torch.cuda.set_sync_debug_mode
    ("error")``, which raises at any PyTorch operation that waits for the
    device (a blocking host-to-device copy, a read to the host): neither
    raises.  A warm gathered-route call (``entry_3d``) raises, at its
    refit loop's round check only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import traceback

    import pandas as pd

    from clustertracking_tpu_torch import refine as refine_mod
    from clustertracking_tpu_torch import refine_leastsq
    from clustertracking_tpu_torch.entry import entry, entry_3d

    def strict(fn, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    solve, args = entry("cuda", B=512, frame_size=128)
    solve(*args)
    torch.cuda.synchronize()
    out = strict(solve, *args)
    torch.cuda.synchronize()
    assert torch.isfinite(out[1]).all()

    solved = []
    real = refine_mod._bucket_solver

    def checked(*a, **k):
        inner, layout = real(*a, **k)

        def call(*args):
            solved.append(1)
            return strict(inner, *args)
        return call, layout

    frames, fidx, params0, _, _ = example_batch(B=64, frame_size=128)
    rows = [{"frame": int(fidx[b]), "y": float(p[2]), "x": float(p[3]),
             "signal": 150.0} for b in range(64) for p in params0[b]]
    f = pd.DataFrame(rows)
    kw = dict(diameter=9, separation=6.0, device="cuda")
    refine_leastsq(f, frames, **kw)
    monkeypatch.setattr(refine_mod, "_bucket_solver", checked)
    out = refine_leastsq(f, frames, **kw)
    assert solved and out["cost"].notna().all()

    solve3, args3 = entry_3d("cuda", B=64, shape=(16, 48, 48))
    solve3(*args3)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError) as info:
        strict(solve3, *args3)
    frames_in = [fr for fr in traceback.extract_tb(info.value.__traceback__)
                 if fr.filename.endswith("refine.py")]
    assert frames_in and ".any()" in frames_in[-1].line
