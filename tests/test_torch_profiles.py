"""Every built-in profile through the LM kernels' plain versions vs the
reference's Pallas kernels, the routing of custom models, and (on a card)
kernel vs plain for each profile.

The profiles: ring (thickness, 'cluster' mode), hat (disc_size,
'cluster'), disc (no extras) and inv_series_2 (both coefficients in 'var'
mode; the default 'global' mode takes lm_solve_global, no kernel).
Scenes are tests/test_pallas_lm.py's 2D dimers drawn with each profile
(inv_series with the gauss it approximates), B=4, 9×9 windows,
max_iter=6, starts perturbed by ±0.2 px and the extras started off their
true values.  The
plain versions (``fused_lm_2d_reference``, ``pixel_lm_reference``) are
held to ``make_pallas_lm(...)`` run as the JAX package's own tests run it
on the CPU (interpret mode): positions, sizes and extras to 1e-4
absolute, signal to 1e-4 relative, npix and converged exactly, n_iter on
lanes that did not converge (the extras' Jacobian rows are autodiff in
both packages; at convergence the plateau exit moves with rounding,
ROADMAP queue 3).

JAX is imported inside the parity tests only, so that the card-only tests
run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_profiles.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.ops.fused_lm import (
    fused_lm_2d, fused_lm_2d_reference)
from clustertracking_tpu_torch.ops.gather import gather_stack, origins_for
from clustertracking_tpu_torch.ops.pixel_lm import (
    check_pixel_lm_args, pixel_lm, pixel_lm_reference, profile_tag)
from clustertracking_tpu_torch.refine import _slot_bounds, kernel_route

torch.set_num_threads(1)

MAX_IT = 6
ATOL = 1e-4
RTOL = 1e-4

# name -> (param modes, drawn profile and its kwargs, extras' true values,
# extras' starts)
PROFILES = {
    "ring": ({}, "ring", dict(thickness=0.25), [0.25], [0.22]),
    "hat": ({}, "hat", dict(disc_size=0.4), [0.4], [0.45]),
    "disc": ({}, "disc", {}, [], []),
    "inv_series_2": ({"coeff_1": "var", "coeff_2": "var"}, "gauss", {},
                     None, [0.55, 0.1]),
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _scene(name, ndim=2, B=4, seed=0, window=None):
    """Dimers drawn with the profile; [B, *frame] frames, one per lane."""
    modes, feat, feat_kw, _, start = PROFILES[name]
    rng = np.random.default_rng(seed)
    model = get_model(name)
    lay = build_layout(model, ndim, True, 2, modes)
    shape = (64, 64) if ndim == 2 else (24, 32, 32)
    size = 1.8 if ndim == 2 else 1.5
    frames = np.zeros((B,) + shape, np.float32)
    params0 = np.zeros((B, 2, lay.n_params), np.float32)
    for b in range(B):
        center = np.asarray(shape, float) / 2 + rng.uniform(-1, 1, ndim)
        true = artificial.draw_cluster(
            frames[b], center, size=size, separation=4.0, n=2, signal=100.0,
            angle=rng.uniform(0, np.pi), feat_func=feat, **feat_kw)
        params0[b, :, 1] = 100.0
        params0[b, :, 2:2 + ndim] = true + rng.uniform(-0.2, 0.2, true.shape)
        params0[b, :, 2 + ndim] = size
        params0[b, :, 3 + ndim:] = start
    frames += np.random.default_rng(seed + 1).normal(
        0.0, 0.5, frames.shape).astype(np.float32)
    if window is None:
        window = (9, 9) if ndim == 2 else (7, 9, 9)
    radius = (3.0,) * ndim
    return model, lay, frames, np.arange(B, dtype=np.int32), params0, \
        window, radius


def _args(model, lay, frames, fidx, params0, window, radius, valid,
          gathered):
    pos = params0[..., list(lay.pos_param_idx)].copy()
    origin = origins_for(_t(pos), window, frames.shape[1:])
    bounds = _slot_bounds(lay, window, frames.shape[1:])
    src = (gather_stack(_t(frames), _t(fidx), origin, window) if gathered
           else (_t(frames), _t(fidx)))
    src = src if isinstance(src, tuple) else (src,)
    args = (lay.vect_from_params(_t(params0)), _t(params0), *src, _t(pos),
            origin, _t(params0[..., 1].max(axis=1)), _t(valid), None)
    kw = dict(model=model, layout=lay, window_shape=window, bounds=bounds,
              radius=radius, max_iter=MAX_IT)
    return args, kw


def _pallas(name, lay, args, kw, fused, frame_shape):
    import jax.numpy as jnp

    from clustertracking_tpu.models import build_layout as jax_build_layout
    from clustertracking_tpu.models import get_model as jax_get_model
    from clustertracking_tpu.ops.pallas_lm import make_pallas_lm

    jmodel = jax_get_model(name)
    jlay = jax_build_layout(jmodel, lay.ndim, lay.isotropic, lay.n_features,
                            dict(zip(lay.param_names, lay.modes)))
    solve = make_pallas_lm(
        jmodel, jlay, kw["window_shape"], kw["bounds"].lo.numpy(),
        kw["bounds"].hi.numpy(), kw["radius"],
        max_iter=MAX_IT, interpret=True, fused_gather=fused,
        frame_shape=frame_shape)
    n_in = 8 if fused else 7
    return solve(*[jnp.asarray(a.numpy()) for a in args[:n_in]])


def _assert_matches(lay, res, jres, valid):
    sig = [int(s) for s in lay.slot_idx[:, lay.signal_param_idx]]
    other = [s for s in range(lay.n_slots) if s not in sig]
    x, jx = res.x.numpy(), np.asarray(jres.x)
    np.testing.assert_allclose(x[:, other], jx[:, other], atol=ATOL, rtol=0)
    np.testing.assert_allclose(x[:, sig], jx[:, sig], rtol=RTOL, atol=0)
    conv = res.converged.numpy()
    np.testing.assert_array_equal(conv, np.asarray(jres.converged))
    np.testing.assert_array_equal(res.n_iter.numpy()[~conv],
                                  np.asarray(jres.n_iter)[~conv])
    np.testing.assert_array_equal(res.npix.numpy()[valid],
                                  np.asarray(jres.npix)[valid])


@pytest.mark.parametrize("name", list(PROFILES))
def test_fused_reference_matches_pallas_fused_kernel(name):
    """fused_lm_2d_reference vs the reference's kernel_fused (frames
    padded to a 128-multiple width, content unchanged)."""
    model, lay, frames, fidx, params0, window, radius = _scene(name)
    frames = np.pad(frames, ((0, 0), (0, 0), (0, 64)))
    valid = np.array([True, True, False, True])
    args, kw = _args(model, lay, frames, fidx, params0, window, radius,
                     valid, gathered=False)
    res = fused_lm_2d_reference(*args, **kw)
    jres = _pallas(name, lay, args, kw, True, frames.shape[1:])
    _assert_matches(lay, res, jres, valid)
    assert (res.cost.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("name", ["ring", "inv_series_2"])
def test_pixel_reference_matches_pallas_3d_kernel(name):
    """pixel_lm_reference vs the reference's `kernel` on 3D windows."""
    model, lay, frames, fidx, params0, window, radius = _scene(name, ndim=3)
    valid = np.ones(4, bool)
    args, kw = _args(model, lay, frames, fidx, params0, window, radius,
                     valid, gathered=True)
    res = pixel_lm_reference(*args, **kw)
    jres = _pallas(name, lay, args, kw, False, None)
    _assert_matches(lay, res, jres, valid)


def test_disc_sigmoid_saturates_as_jax():
    """The kernels' disc edge, 1/(1 + exp(−x)) in float32, against
    jax.nn.sigmoid and torch.sigmoid across and past both saturation
    ends: 2e-7 absolute (a float32 ulp of 1), exactly 1 and 0 far out."""
    import jax
    import jax.numpy as jnp

    x = np.concatenate([np.linspace(-120, 120, 481),
                        [-88.8, -87.3, -16.7, 16.7, 87.3, 88.8]]
                       ).astype(np.float32)
    with np.errstate(over="ignore"):
        mine = (np.float32(1) / (np.float32(1) + np.exp(-x))).astype(
            np.float32)
    ref = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    np.testing.assert_allclose(mine, ref, rtol=0, atol=2e-7)
    np.testing.assert_allclose(torch.sigmoid(_t(x)).numpy(), ref, rtol=0,
                               atol=2e-7)
    assert mine[x >= 20].min() == 1.0 and mine[x <= -104].max() == 0.0


def test_every_builtin_profile_has_a_kernel_tag():
    tags = [profile_tag(get_model(nm)) for nm in
            ("gauss", "ring", "hat", "disc", "inv_series_1",
             "inv_series_8")]
    assert tags == [0, 1, 2, 3, 4, 4]
    assert profile_tag(get_model("inv_series_9")) is None   # past the cap


def _custom():
    return get_model({"name": "lorentz", "params": [],
                      "fun": lambda r2: 1.0 / (1.0 + r2)})


@pytest.mark.parametrize("ndim,window", [(2, (13, 13)), (3, (7, 9, 9))])
def test_custom_models_route_to_lm_solve(ndim, window):
    """A custom model is a Python callable: kernel_route sends its buckets
    to lm_solve (a static route), the built-ins to their kernels, and
    buckets of 20 slots or more (n = 8) to the block kernel: it takes
    every built-in profile."""
    for name in ("ring", "hat", "disc"):
        lay = build_layout(get_model(name), ndim, True, 2, {})
        assert kernel_route(get_model(name), lay, False, None, window) == (
            "fused" if ndim == 2 else "gathered")
        lay = build_layout(get_model(name), ndim, True, 8, {})
        assert kernel_route(get_model(name), lay, False, None,
                            window) == "block"
    for n in (2, 8):
        lay = build_layout(get_model("inv_series_2"), ndim, True, n,
                           {"coeff_1": "var", "coeff_2": "cluster"})
        assert kernel_route(get_model("inv_series_2"), lay, False, None,
                            window) is not None
    model = _custom()
    for n in (2, 8):
        lay = build_layout(model, ndim, True, n, {})
        assert kernel_route(model, lay, False, None, window) is None


def test_custom_model_refine_takes_lm_solve():
    """refine_leastsq with a custom model dict records the 'torch' route
    and fits the dimer (the model is a Lorentzian drawn as such)."""
    import pandas as pd

    from clustertracking_tpu_torch import diagnostics, refine_leastsq

    img = np.zeros((48, 48))
    true = artificial.draw_cluster(img, (24, 24), size=2.0, separation=5.0,
                                   n=2, signal=100.0, angle=0.3,
                                   feat_func=lambda r2: 1.0 / (1.0 + r2))
    f = pd.DataFrame(true + 0.2, columns=["y", "x"])
    f["frame"] = 0
    with diagnostics.collect() as stats:
        out = refine_leastsq(f, img, diameter=9, separation=6.0,
                             fit_function=_custom(),
                             param_val={"size": 2.0}, device="cpu")
    assert {b.backend for b in stats.batches} == {"cpu-torch"}
    assert np.abs(out[["y", "x"]].to_numpy() - true).max() < 1e-3


def test_check_args_refuses_custom_models():
    model, lay, frames, fidx, params0, window, radius = _scene("ring")
    args, kw = _args(model, lay, frames, fidx, params0, window, radius,
                     np.ones(4, bool), gathered=True)
    args = list(args[:7]) + [torch.ones(4, 2)]
    check_pixel_lm_args(*args, model=model, layout=lay, window_shape=window,
                        bounds=kw["bounds"])
    custom = _custom()
    clay = build_layout(custom, 2, True, 2, {})
    args[0] = clay.vect_from_params(args[1][..., :clay.n_params])
    args[1] = args[1][..., :clay.n_params].contiguous()
    with pytest.raises(NotImplementedError, match="queue 2 item 1"):
        check_pixel_lm_args(*args, model=custom, layout=clay,
                            window_shape=window, bounds=kw["bounds"])


def _agree(res_k, res_p, lay):
    """Kernel vs plain on the card: positions, sizes and extras 1e-3,
    cost 1e-3 relative, npix and converged equal."""
    sig = [int(s) for s in lay.slot_idx[:, lay.signal_param_idx]]
    other = [s for s in range(lay.n_slots) if s not in sig]
    xk, xp = res_k.x.cpu().numpy(), res_p.x.cpu().numpy()
    np.testing.assert_allclose(xk[:, other], xp[:, other], atol=1e-3, rtol=0)
    np.testing.assert_allclose(xk[:, sig], xp[:, sig], rtol=1e-3, atol=0)
    np.testing.assert_allclose(res_k.cost.cpu().numpy(),
                               res_p.cost.cpu().numpy(), rtol=1e-3)
    np.testing.assert_array_equal(res_k.npix.cpu().numpy(),
                                  res_p.npix.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PROFILES))
@pytest.mark.parametrize("route", ["fused", "resident", "streamed"])
def test_kernel_matches_plain_on_the_card(name, route):
    """csrc/fused_lm_2d.cu (2D) and csrc/pixel_lm.cu (3D, both modes) vs
    their plain versions for each non-gauss profile, B=64, 60 LM
    iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ndim = 2 if route == "fused" else 3
    model, lay, frames, fidx, params0, window, radius = _scene(
        name, ndim=ndim, B=64)
    args, kw = _args(model, lay, frames, fidx, params0, window, radius,
                     np.ones(64, bool), gathered=route != "fused")
    args = [a.to("cuda") if a is not None else None for a in args]
    kw.update(max_iter=60, bounds=kw["bounds"].to("cuda"))
    if route == "fused":
        before = fused_lm_2d.launches
        res_k = fused_lm_2d(*args, **kw)
        assert fused_lm_2d.launches == before + 1
        res_p = fused_lm_2d_reference(*args, **kw)
    else:
        res_k = pixel_lm(*args, **kw, streaming=route == "streamed")
        res_p = pixel_lm_reference(*args, **kw)
    torch.cuda.synchronize()
    _agree(res_k, res_p, lay)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ring", "hat", "disc", "inv_series_2"])
def test_refine_leastsq_profiles_launch_kernels_on_the_card(name):
    """refine_leastsq(model=...) on CUDA takes fused_lm_2d (2D) with no
    NotImplementedError and agrees with the plain route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pandas as pd

    from clustertracking_tpu_torch import diagnostics, refine_leastsq

    model, lay, frames, fidx, params0, window, radius = _scene(name, B=2)
    rows = [{"frame": b, "y": p[2], "x": p[3], "signal": 100.0}
            for b in range(2) for p in params0[b]]
    f = pd.DataFrame(rows)
    kw = dict(diameter=7, separation=5.0, fit_function=name,
              param_mode=PROFILES[name][0], param_val={"size": 1.8},
              device="cuda")
    before = fused_lm_2d.launches
    with diagnostics.collect() as stats:
        out_k = refine_leastsq(f, frames, **kw)
    out_p = refine_leastsq(f, frames, lm_backend="torch", **kw)
    assert fused_lm_2d.launches > before
    assert {b.backend for b in stats.batches} == {"cuda-fused"}
    np.testing.assert_allclose(out_k[["y", "x"]].to_numpy(),
                               out_p[["y", "x"]].to_numpy(), atol=1e-3)
