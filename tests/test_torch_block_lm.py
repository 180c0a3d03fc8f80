"""The block route's LM (unconstrained buckets of 20 slots or more): plain
version vs the reference's XLA route, the bucket solver and
refine_leastsq through the route, the wrapper's refusals and (on a card)
kernel vs plain.

``block_lm_reference`` is held to the JAX package's ``ops/lm.py::lm_solve``
with its ``make_model_fns`` closures, the call the reference makes for
such buckets (refine.py:553-558), on the same numpy inputs: chains of
Gaussians drawn with noise (sigma 1 on signal 140), as config 5's chains
are, with a pad feature (fvalid 0) and a padding lane (valid False).
Tolerances as tests/test_torch_refine.py states them: positions to 1e-4
px, cost to 1e-4 relative on lanes whose rms is at least 1e-5, converged
exactly, n_iter exactly on lanes that did not converge (at convergence the
plateau exit moves with float32 rounding, ROADMAP queue 3).  On the card
the kernel is held to the plain version by PERF.md's "Kernel vs plain"
gates: positions 1e-3 px, cost 1e-3 relative, converged equal.

JAX is imported inside the parity tests only, so that the card-only tests
run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_block_lm.py -m cuda``.
"""
import functools

import numpy as np
import pytest
import torch

from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.ops.block_lm import (
    BLOCK_MAX_FEATURES, BLOCK_MAX_SLOTS, block_lm, block_lm_reference,
    check_block_lm_args, smem_words)
from clustertracking_tpu_torch.ops.gather import (
    gather_stack, origins_for, radius_mask)
from clustertracking_tpu_torch.ops.pixel_lm import SlotBounds
from clustertracking_tpu_torch.refine import _slot_bounds, _window_shape

torch.set_num_threads(1)

MAX_IT = 60
ATOL = 1e-4
RTOL = 1e-4
RMS_FLOOR = 1e-5
SEPARATION = 5.5
ANISO_2D = {"size_y": "var", "size_x": "var"}   # 5 slots a feature
ANISO_3D = {"size_z": "var", "size_y": "var", "size_x": "var"}   # 7


EXTRAS = {"thickness": 0.2, "disc_size": 0.5, "coeff_1": 0.1,
          "coeff_2": 0.05}


def _chain_scene(n, n_live, B, ndim=2, isotropic=True, modes=None,
                 model="gauss", seed=0):
    """B frames, each with one chain of ``n_live`` features about 4.5 px
    apart (a walk that turns by up to 50°), rendered by the model itself
    and with noise; the bucket holds n features, the last n - n_live of
    them pad features (copies of the last live one, fvalid 0).  The last
    lane is padding (valid False).  Returns the layout, the window and the
    solve's inputs as numpy arrays."""
    from clustertracking_tpu_torch.ops.residual import make_model_fns

    rng = np.random.default_rng(seed)
    if ndim == 2:
        shape = (128, 128) if n <= 16 else (256, 256)
        size, radius = np.array([2.0, 2.0]), (4.5, 4.5)
    else:
        shape = (32, 64, 64)
        size, radius = np.array([1.5, 2.0, 2.0]), (3.5, 4.5, 4.5)
    spec = get_model(model)
    lay = build_layout(spec, ndim, isotropic, n, modes or {})
    names = lay.param_names
    axes = "yx" if ndim == 2 else "zyx"
    truth = np.zeros((B, n, lay.n_params), np.float32)
    for b in range(B):
        pos, ang, feats = np.zeros(ndim), rng.uniform(-0.3, 0.3), []
        for _ in range(n_live):
            feats.append(pos + rng.uniform(-0.5, 0.5, ndim))
            ang += rng.uniform(-0.9, 0.9)
            pos = pos.copy()
            pos[-2:] += 4.5 * np.array([np.sin(ang), np.cos(ang)])
        feats = np.asarray(feats)
        feats += np.asarray(shape, float) / 2 - feats.mean(0)
        for i in range(n):
            row = dict(EXTRAS, background=0.0, size=float(size.mean()),
                       signal=140.0 * rng.uniform(0.9, 1.1))
            for d, ax in enumerate(axes):
                row[ax] = feats[min(i, n_live - 1), d]
                row[f"size_{ax}"] = size[d]
            truth[b, i] = [row[name] for name in names]
    fvalid = np.zeros((B, n), np.float32)
    fvalid[:, :n_live] = 1.0
    t = torch.as_tensor
    image = make_model_fns(spec, lay, shape).image_from_params
    frames = image(t(truth), torch.zeros((B, ndim), dtype=torch.int32),
                   t(fvalid)).reshape((B,) + shape).numpy()
    frames = (frames + rng.normal(0.0, 1.0, frames.shape)).astype(
        np.float32)
    params = truth.copy()
    pos_idx = list(lay.pos_param_idx)
    params[..., pos_idx] += rng.uniform(-0.3, 0.3, params[..., pos_idx].shape)
    params[..., lay.signal_param_idx] *= rng.uniform(0.85, 1.1, (B, n))
    valid = np.ones(B, bool)
    valid[-1] = False
    window = _window_shape(n, ndim, radius, (SEPARATION,) * ndim, shape)
    params_t = t(params)
    pos_at = params_t[..., pos_idx].contiguous()
    origin = origins_for(pos_at, window, shape)
    fidx = torch.arange(B, dtype=torch.int32)
    pixels = gather_stack(t(frames), fidx, origin, window)
    mask = radius_mask(pos_at, origin, window, radius, fvalid=t(fvalid))
    norm = torch.clamp(torch.amax(params_t[..., lay.signal_param_idx].abs(),
                                  dim=1), min=1e-6)
    bounds = _slot_bounds(lay, window, shape)
    inputs = dict(vect0=lay.vect_from_params(params_t).numpy(),
                  const_params=params, pixels=pixels.numpy(),
                  mask=mask.numpy(), origin=origin.numpy(),
                  norm=norm.numpy(), valid=valid, fvalid=fvalid,
                  lo=bounds.lo.numpy(), hi=bounds.hi.numpy())
    return lay, window, inputs


def _torch_args(lay, inputs, device="cpu"):
    keys = ("vect0", "const_params", "pixels", "mask", "origin", "norm",
            "valid", "fvalid")
    args = [torch.as_tensor(inputs[k]).to(device) for k in keys]
    return args, dict(bounds=SlotBounds(lay, None, inputs["lo"],
                                        inputs["hi"], device))


def _plain(lay, window, inputs, model="gauss"):
    args, bounds = _torch_args(lay, inputs)
    return block_lm_reference(*args, model=get_model(model), layout=lay,
                              window_shape=window, max_iter=MAX_IT,
                              **bounds)


def _jax_lm_solve(lay, window, inputs, model="gauss"):
    import jax.numpy as jnp

    from clustertracking_tpu.models import build_layout as jax_layout
    from clustertracking_tpu.models import get_model as jax_model
    from clustertracking_tpu.ops.lm import lm_solve
    from clustertracking_tpu.ops.residual import make_model_fns

    jlay = jax_layout(jax_model(model), lay.ndim, lay.isotropic,
                      lay.n_features, dict(zip(lay.param_names, lay.modes)))
    np.testing.assert_array_equal(jlay.slot_idx, lay.slot_idx)
    fns = make_model_fns(jax_model(model), jlay, tuple(window))
    a = {k: jnp.asarray(v) for k, v in inputs.items()}
    res = lm_solve(
        fns.residual, fns.residual_jac, a["vect0"],
        (a["const_params"], a["pixels"], a["mask"], a["origin"], a["norm"],
         a["fvalid"]),
        max_iter=MAX_IT, lower=a["lo"], upper=a["hi"], valid=a["valid"])
    return [np.asarray(v) for v in res[:4]]


def _pos_slots(lay):
    return sorted({int(s) for p in lay.pos_param_idx
                   for s in lay.slot_idx[:, p] if s >= 0})


def _assert_matches_jax(res, jres, lay, npix):
    x, cost, n_iter, conv = (v.numpy() for v in res[:4])
    jx, jcost, jn_iter, jconv = jres
    pos = _pos_slots(lay)
    np.testing.assert_allclose(x[:, pos], jx[:, pos], atol=ATOL, rtol=0)
    rms = np.sqrt(jcost / np.maximum(npix, 1.0))
    live = rms >= RMS_FLOOR
    assert live.any()
    np.testing.assert_allclose(cost[live], jcost[live], rtol=RTOL)
    np.testing.assert_array_equal(conv, jconv)
    running = ~conv & ~jconv
    np.testing.assert_array_equal(n_iter[running], jn_iter[running])


CHAINS = {
    # name: (n, live features, lanes, ndim, isotropic, modes)
    "chain8_v24": (8, 8, 3, 2, True, None),
    "chain16_v48_pad": (16, 15, 3, 2, True, None),
    "aniso4_v20_clamped": (4, 4, 3, 2, False, ANISO_2D),
    "aniso5_v25_rejecting": (5, 5, 3, 2, False, ANISO_2D),
    "trimer3d_v21": (3, 3, 3, 3, False, ANISO_3D),
}


@pytest.mark.parametrize("case", list(CHAINS))
def test_reference_matches_jax_lm_solve(case):
    """block_lm_reference against the reference's XLA route on chain
    scenes: V = 24 and 48 (one pad feature), V = 20 (the clamped Cholesky
    of _chol_solve_unrolled) and V = 25 (the library Cholesky, which
    rejects a step whose pivot is not positive), and a 3D trimer with
    per-axis sizes (V = 21)."""
    n, live, B, ndim, iso, modes = CHAINS[case]
    lay, window, inputs = _chain_scene(n, live, B, ndim, iso, modes)
    assert lay.n_slots >= 20
    res = _plain(lay, window, inputs)
    jres = _jax_lm_solve(lay, window, inputs)
    npix = inputs["mask"].sum(1)
    np.testing.assert_array_equal(res.npix.numpy(), npix)
    _assert_matches_jax(res, jres, lay, npix)
    # the padding lane: its clipped start, the cost there, no iteration
    x0 = np.clip(inputs["vect0"][-1], inputs["lo"], inputs["hi"])
    np.testing.assert_array_equal(res.x[-1].numpy(), x0)
    assert res.n_iter[-1] == 0 and not res.converged[-1]


def test_wrapper_on_cpu_returns_the_plain_version():
    lay, window, inputs = _chain_scene(8, 7, 2)
    args, bounds = _torch_args(lay, inputs)
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              max_iter=8, **bounds)
    before = block_lm.launches
    for a, b in zip(block_lm(*args, **kw), block_lm_reference(*args, **kw)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert block_lm.launches == before


def test_wrapper_refuses_other_devices():
    lay, window, inputs = _chain_scene(8, 8, 2)
    args, bounds = _torch_args(lay, inputs, "meta")
    with pytest.raises(ValueError, match="device"):
        block_lm(*args, model=get_model("gauss"), layout=lay,
                 window_shape=window, **bounds)


def _checked(which, bad):
    lay, window, inputs = _chain_scene(8, 8, 2)
    args, bounds = _torch_args(lay, inputs)
    names = ("vect0", "const_params", "pixels", "mask", "origin", "norm",
             "valid", "fvalid")
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              **bounds)
    if which in names:
        args[names.index(which)] = bad(args[names.index(which)])
    elif which == "lo":
        kw["bounds"] = SlotBounds(lay, None, bad(kw["bounds"].lo),
                                  kw["bounds"].hi)
    else:
        kw[which] = bad(kw[which])
    check_block_lm_args(*args, **kw)


def test_check_block_lm_args_accepts_a_chain_bucket():
    _checked("vect0", lambda a: a)


@pytest.mark.parametrize("which,bad,err", [
    ("vect0", lambda a: a[:, :-1].contiguous(), ValueError),
    ("pixels", lambda a: a[:, :-1].contiguous(), ValueError),
    ("mask", lambda a: a.to(torch.float64), TypeError),
    ("mask", lambda a: a.t().contiguous().t(), ValueError),
    ("origin", lambda a: a.to(torch.float32), TypeError),
    ("fvalid", lambda a: a[:, :4].contiguous(), ValueError),
    ("lo", lambda a: a[:-1].contiguous(), ValueError),
    ("window_shape", lambda w: (9, 9, 9), ValueError),
    ("layout", lambda lay: build_layout(get_model("gauss"), 2, True, 43),
     ValueError),
    ("model", lambda m: get_model({"params": [], "fun": lambda r2: r2}),
     NotImplementedError),
])
def test_check_block_lm_args_refuses(which, bad, err):
    with pytest.raises(err):
        _checked(which, bad)


def test_caps_fit_a_block():
    """Every instantiation fits the 227 KB of shared memory a block can
    have on an H100 at the caps, and config 5's largest bucket (n = 40,
    V = 120) is inside them."""
    for D in (2, 3):
        for prof in range(5):
            assert 4 * smem_words(D, prof, BLOCK_MAX_SLOTS,
                                  BLOCK_MAX_FEATURES) <= 232448
    assert 4 * smem_words(2, 0, 120, 40) <= 232448
    assert build_layout(get_model("gauss"), 2, True, 40).n_slots == 120
    assert 120 <= BLOCK_MAX_SLOTS and 40 <= BLOCK_MAX_FEATURES


@pytest.mark.parametrize("n", range(8, 21))
def test_config5_chain_shapes_fit_two_blocks(n):
    """Config 5's chains (2D isotropic Gaussians, 3 slots a feature: V =
    24–60 for n = 8–20) fit two blocks in the 232,448 bytes of shared
    memory an H100 SM gives its blocks, so 256 blocks run in one wave."""
    V = build_layout(get_model("gauss"), 2, True, n).n_slots
    assert V == 3 * n
    assert 2 * 4 * smem_words(2, 0, V, n) <= 232448


@pytest.mark.parametrize("D,prof", [(D, p) for D in (2, 3) for p in range(5)])
def test_two_blocks_up_to_v64_and_the_caps_fit_one(D, prof):
    """Every profile, 2D and 3D: two blocks fit an SM at V ≤ 64 with
    n ≤ 32 (pixel rows a chunk: 256 up to V + 1 = 32, 192 up to 72
    columns, 128 past them), one at the caps.  smem_words grows with V
    and n at each chunk size."""
    for V in range(20, 65):
        assert 2 * 4 * smem_words(D, prof, V, min(32, V)) <= 232448
    assert 4 * smem_words(D, prof, BLOCK_MAX_SLOTS,
                          BLOCK_MAX_FEATURES) <= 232448
    assert smem_words(D, prof, 31, 8) < smem_words(D, prof, 31, 9)
    assert smem_words(D, prof, 100, 20) < smem_words(D, prof, 101, 20)


def _refine_scene():
    """Two frames, each with a chain of 9 features (ladder bucket 10, one
    pad feature, V = 30) and one of 16 (V = 48), with noise."""
    import pandas as pd

    rng = np.random.default_rng(3)
    frames = np.zeros((2, 128, 160))
    rows = []
    for t in range(2):
        for n, y0 in ((9, 35.0), (16, 95.0)):
            ang = rng.uniform(-0.2, 0.2)
            p = np.array([y0, 20.0])
            for _ in range(n):
                artificial.draw_feature(frames[t], p, 2.0, 140.0)
                q = p + rng.uniform(-0.3, 0.3, 2)
                rows.append({"frame": t, "y": q[0], "x": q[1],
                             "signal": 140.0})
                ang = np.clip(ang + rng.uniform(-0.6, 0.6), -0.7, 0.7)
                p = p + 4.6 * np.array([np.sin(ang), np.cos(ang)])
    frames += rng.normal(0.0, 1.0, frames.shape)
    return pd.DataFrame(rows), frames, dict(
        diameter=9, separation=SEPARATION, max_cluster_size=16,
        param_val={"size": 2.0})


def test_refine_leastsq_block_route_on_cpu_matches_torch_and_jax():
    """refine_leastsq with lm_backend='kernel' (the block route's plain
    version on the CPU) equals lm_backend='torch' bit for bit, tags the
    chain dispatches cpu-block, and both agree with the reference's
    refine_leastsq (XLA)."""
    import pandas as pd

    import clustertracking_tpu as ct
    import clustertracking_tpu_torch as ctt
    from clustertracking_tpu_torch import diagnostics

    refine_cpu = functools.partial(ctt.refine_leastsq, device="cpu")
    f, frames, kw = _refine_scene()
    with diagnostics.collect() as stats:
        out_k = refine_cpu(f, frames, lm_backend="kernel", **kw)
    out_t = refine_cpu(f, frames, lm_backend="torch", **kw)
    assert {(b.cluster_size, b.backend) for b in stats.batches} == {
        (10, "cpu-block"), (16, "cpu-block")}
    pd.testing.assert_frame_equal(out_k, out_t)
    jout = ct.refine_leastsq(f, frames, lm_backend="xla", **kw)
    np.testing.assert_array_equal(out_k["cluster_size"].to_numpy(),
                                  jout["cluster_size"].to_numpy())
    np.testing.assert_allclose(out_k[["y", "x"]].to_numpy(),
                               jout[["y", "x"]].to_numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out_k["signal"].to_numpy(),
                               jout["signal"].to_numpy(), rtol=RTOL)
    np.testing.assert_allclose(out_k["cost"].to_numpy(),
                               jout["cost"].to_numpy(), rtol=RTOL,
                               atol=2.0 ** -23)
    np.testing.assert_array_equal(out_k["fit_converged"].to_numpy(),
                                  jout["fit_converged"].to_numpy())
    assert out_k["cost"].notna().all()


def _card_agree(res_k, res_p, lay):
    pos = _pos_slots(lay)
    np.testing.assert_allclose(res_k.x.cpu().numpy()[:, pos],
                               res_p.x.cpu().numpy()[:, pos], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(res_k.cost.cpu().numpy(),
                               res_p.cost.cpu().numpy(), rtol=1e-3)
    np.testing.assert_array_equal(res_k.converged.cpu().numpy(),
                                  res_p.converged.cpu().numpy())
    np.testing.assert_array_equal(res_k.npix.cpu().numpy(),
                                  res_p.npix.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case,model,extra_modes", [
    (c, "gauss", {}) for c in CHAINS] + [
    ("chain8_v24", "ring", {}),
    ("chain8_v24", "inv_series_2", {"coeff_1": "cluster",
                                    "coeff_2": "cluster"})])
def test_kernel_matches_plain_on_the_card(case, model, extra_modes):
    """csrc/block_lm.cu against block_lm_reference on the same CUDA
    tensors: each chain scene, and two other profiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, live, B, ndim, iso, modes = CHAINS[case]
    lay, window, inputs = _chain_scene(n, live, 8, ndim, iso,
                                       dict(modes or {}, **extra_modes),
                                       model=model)
    args, bounds = _torch_args(lay, inputs, "cuda")
    kw = dict(model=get_model(model), layout=lay, window_shape=window,
              max_iter=MAX_IT, **bounds)
    before = block_lm.launches
    res_k = block_lm(*args, **kw)
    torch.cuda.synchronize()
    assert block_lm.launches == before + 1
    _card_agree(res_k, block_lm_reference(*args, **kw), lay)


TILE_EDGES = {
    # name: (n, live features, ndim, isotropic, modes); V = layout slots
    "v20_size_var": (5, 5, 2, True, {"size": "var"}),
    "v21_chain7": (7, 7, 2, True, None),
    "v64_shared_background": (21, 20, 2, True, {"background": "cluster"}),
    "v128_size_var": (32, 30, 2, True, {"size": "var"}),
    "v32_chain3d": (8, 8, 3, True, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILE_EDGES))
def test_kernel_matches_plain_at_tile_edges_on_the_card(case):
    """The kernel's 8-column tiles of zᵀz at their edges: V = 20 (K = 21,
    three blocks, one job sliced over 8 warps), V = 21, V = 64 (K = 65
    spills one column into a ninth block, nine jobs; one background slot
    that every feature shares), V = 128 (the cap: 17 blocks, 25 jobs) and
    a 3D chain (V = 32, K = 33: two panels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, live, ndim, iso, modes = TILE_EDGES[case]
    lay, window, inputs = _chain_scene(n, live, 6, ndim, iso, modes, seed=4)
    assert lay.n_slots == int(case[1:].split("_")[0])
    args, bounds = _torch_args(lay, inputs, "cuda")
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              max_iter=MAX_IT, **bounds)
    res_k = block_lm(*args, **kw)
    torch.cuda.synchronize()
    _card_agree(res_k, block_lm_reference(*args, **kw), lay)


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_cap_on_the_card():
    """A bucket of 40 features (V = 120), config 5's largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lay, window, inputs = _chain_scene(40, 38, 4, seed=2)
    args, bounds = _torch_args(lay, inputs, "cuda")
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              max_iter=MAX_IT, **bounds)
    res_k = block_lm(*args, **kw)
    torch.cuda.synchronize()
    _card_agree(res_k, block_lm_reference(*args, **kw), lay)
