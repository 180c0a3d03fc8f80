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
    check_kernel_args, fused_lm_2d, fused_lm_2d_reference, kernel_mask,
    kernel_route)
from clustertracking_tpu_torch.ops.gather import origins_for, radius_mask
from clustertracking_tpu_torch.refine import _slot_bounds

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
    lo, hi = _slot_bounds(lay, WINDOW, frames.shape[1:])
    return lay, frames, fidx, params0, pos0, origin, norm, lo, hi


def _run_both(n, modes, valid):
    import jax.numpy as jnp

    from clustertracking_tpu.models import build_layout as jax_build_layout
    from clustertracking_tpu.models import get_model as jax_get_model
    from clustertracking_tpu.ops.pallas_lm import make_pallas_lm

    lay, frames, fidx, params0, pos0, origin, norm, lo, hi = _scene(n, modes)
    jlay = jax_build_layout(jax_get_model("gauss"), 2, True, n, modes)
    vect0 = jlay.vect_from_params(jnp.asarray(params0))
    psolve = make_pallas_lm(
        jax_get_model("gauss"), jlay, WINDOW, lo, hi, RADIUS,
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
              lo=lo, hi=hi, radius=RADIUS, max_iter=MAX_IT)
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
    lay, frames, fidx, params0, pos0, origin, norm, lo, hi = _scene(n, {})
    args = [lay.vect_from_params(_t(params0)), _t(params0), _t(frames),
            _t(fidx), _t(pos0), _t(origin), _t(norm),
            torch.ones(B, dtype=torch.bool), torch.ones(B, n)]
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=WINDOW)
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
        fused_lm_2d(*args, **kw, lo=np.zeros(6), hi=np.ones(6),
                    radius=RADIUS)


@pytest.mark.parametrize("n,modes,use_global,window,expect", [
    (2, {}, False, (13, 13), "fused"),
    (6, {}, False, (24, 24), "fused"),               # V = 18
    (8, {}, False, (32, 32), None),                  # V = 24 >= 20
    (2, {}, True, (13, 13), None),                   # global-tied slots
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
    lo, hi = _slot_bounds(lay, window, (128, 128))
    args = (lay.vect_from_params(p0), p0, _t(frames).to(dev),
            _t(fidx).to(dev), pos, origin, p0[..., 1].amax(dim=1),
            _t(valid).to(dev), None)
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              lo=lo, hi=hi, radius=(4.5, 4.5), max_iter=60)
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
    whose last lanes are padding (valid False)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
    before = fused_lm_2d.launches
    pk, rk, ck, ik, _ = kernel_route(*args)
    pp, rp, cp, ip, _ = plain_route(*args)
    torch.cuda.synchronize()
    assert fused_lm_2d.launches - before >= 2  # a second refit round ran
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
    V = 20 slots and is routed to lm_solve."""
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
                                                   "cuda-torch"}
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
