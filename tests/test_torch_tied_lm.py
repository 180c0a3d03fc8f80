"""The tied route: ``csrc/tied_lm.cu``'s routing, argument checks and
packing, and its plain version ``tied_lm_reference`` held to the JAX
package's ``lm_solve_global`` on the same numpy inputs.

Buckets: ``train_leastsq``'s inv_series_2 layouts (n = 1 and 2, the
coefficients tied, the size held) and a 2D ``dimer_global()`` bucket (the
n-gon pose, its fitted distance tied), rendered by the model with noise
σ=1 on signal 180, every lane in its own frame, the last lane invalid.
The reference's closures are its ``make_model_fns`` and, rigid, the
chain rule of its refine.py:256-300, written out here.  Tolerances, as
tests/test_torch_global.py states them: x within 1e-5 (1e-4 where a fit
reaches the float32 floor) on every slot but the signals, which are ~180
and held within 1e-6 relative (one float32 ulp there is 1.5e-5; the
rigid bucket's pose Jacobian is the chain rule in both packages but
rounds apart, and its signals end 4 ulp apart), cost within 1e-5
relative plus 4e-6 absolute, converged equal on every lane; n_iter
equal on a solve cut before convergence.

JAX is imported inside the parity tests only, so that the card tests run
where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_tied_lm.py -m cuda``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import diagnostics
from clustertracking_tpu_torch.constraints import (
    Constraint, dimer_global, positions_to_pose)
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.ops.gather import (
    gather_stack, origins_for, radius_mask)
from clustertracking_tpu_torch.ops.residual import make_model_fns
from clustertracking_tpu_torch.ops.rigid import (
    make_constrained_fns, rigid_kernel_slots)
from clustertracking_tpu_torch.ops.pixel_lm import pose_kind, profile_tag
from clustertracking_tpu_torch.ops.tied_lm import (
    CTA_WARPS, SMEM_MAX, check_tied_lm_args, launch_plan, slot_ceiling,
    tie_supported, tied_lm, tied_lm_clocks, tied_lm_reference)
from clustertracking_tpu_torch.refine import (
    _slot_bounds, _tied_slots, _uses_global, _window_shape, kernel_route)

torch.set_num_threads(1)

MAX_IT = 60
X_ATOL = 1e-5
X_FLOOR_ATOL = 1e-4
X_SIGNAL_RTOL = 1e-6   # signals of ~180: one float32 ulp is 1.5e-5
COST_RTOL = 1e-5
COST_ATOL = 4e-6
# on the card: chip_smoke.py's gates for tied_lm against its plain version
TIED_RTOL = 1e-4
POS_ATOL = 1e-3
CARD_COST_RTOL = 1e-3
RMS_FLOOR = 1e-5

TRAIN_MODES = {"size": "const"}
# the profiles' extra parameters: drawn, and (each lane near) the start
EXTRAS = {"coeff_1": 0.8, "coeff_2": 0.25, "thickness": 0.3,
          "disc_size": 0.5}
EXTRA_STARTS = {"coeff_1": 0.5, "coeff_2": 0.1, "thickness": 0.35,
                "disc_size": 0.45}
# frame shape, diameter and separation by rank
GEOMETRY = {2: ((64, 64), (11, 11), (6.0, 6.0)),
            3: ((16, 48, 48), (7, 9, 9), (5.5, 5.5, 5.5))}

# name: (model, ndim, n, modes, constraint)
BUCKETS = {
    "inv_series_2_n1": ("inv_series_2", 2, 1, TRAIN_MODES, None),
    "inv_series_2_n2": ("inv_series_2", 2, 2, TRAIN_MODES, None),
    "dimer_global_ngon": ("gauss", 2, 2, {}, "dimer_global"),
    "dimer_global_axis": ("gauss", 3, 2, {}, "dimer_global"),
}


def _constraint(name, ndim=2):
    return None if name is None else dimer_global(ndim=ndim)


def _bucket(name, B=6, seed=0):
    """A tied bucket's solve inputs as the bucket solver builds them (numpy
    arrays): each of B lanes a cluster of n features 5 px apart in its own
    frame, rendered by the model with noise σ=1; the fit starts 0.3 px
    off, its signals 15% off and each lane's tied slots elsewhere (the
    start's tie takes their mean).  The last lane is invalid."""
    model_name, ndim, n, modes, con_name = BUCKETS[name]
    rng = np.random.default_rng(seed)
    model = get_model(model_name)
    con = _constraint(con_name, ndim)
    lay = build_layout(model, ndim, True, n, modes)
    shape, diameter, separation = GEOMETRY[ndim]
    radius = tuple(d / 2.0 for d in diameter)
    window = _window_shape(n, ndim, radius, separation, shape)
    names = lay.param_names
    axes = "yx" if ndim == 2 else "zyx"
    truth = np.zeros((B, n, lay.n_params), np.float32)
    for b in range(B):
        ang = rng.uniform(0, np.pi)
        bond = np.array([np.sin(ang), np.cos(ang)])
        if ndim == 3:   # mostly in the plane, as a z-stack's dimers lie
            bond = np.concatenate([[rng.uniform(-0.3, 0.3)], bond])
            bond /= np.linalg.norm(bond)
        center = np.asarray(shape, float) / 2 + rng.uniform(-2, 2, ndim)
        for i in range(n):
            pos = center + (i - (n - 1) / 2) * 5.0 * bond
            row = dict(EXTRAS, background=2.0, signal=180.0, size=2.0,
                       **dict(zip(axes, pos)))
            truth[b, i] = [row[k] for k in names]
    t = torch.as_tensor
    fvalid = np.ones((B, n), np.float32)
    image = make_model_fns(model, lay, shape).image_from_params
    frames = image(t(truth), torch.zeros((B, ndim), dtype=torch.int32),
                   t(fvalid)).reshape((B,) + shape).numpy()
    frames = (frames + rng.normal(0.0, 1.0, frames.shape)).astype(
        np.float32)
    params = truth.copy()
    pos_idx = list(lay.pos_param_idx)
    params[..., pos_idx] += rng.uniform(-0.3, 0.3, (B, n, ndim))
    params[..., lay.signal_param_idx] *= rng.uniform(0.85, 1.15, (B, n))
    for extra in model.extra_params:
        params[..., names.index(extra)] = EXTRA_STARTS[extra] + rng.uniform(
            -0.05, 0.05, (B, 1))
    valid = np.ones(B, bool)
    valid[-1] = False
    params_t = t(params)
    if con is None:
        vect0 = lay.vect_from_params(params_t)
        pos_at = params_t[..., pos_idx].contiguous()
    else:
        pose0 = positions_to_pose(params[..., pos_idx].astype(float), con)
        pose0[:, -1] *= rng.uniform(0.9, 1.1, B)   # each lane's distance
        cfns = make_constrained_fns(model, lay, window, con)
        vect0 = cfns.vect_of(params_t, t(pose0.astype(np.float32)))
        pos_at = cfns.positions_of(vect0, params_t).contiguous()
    origin = origins_for(pos_at, window, shape)
    pixels = gather_stack(t(frames), torch.arange(B, dtype=torch.int32),
                          origin, window)
    fv = None if con is not None else t(fvalid)
    mask = radius_mask(pos_at, origin, window, radius, fvalid=fv)
    norm = torch.clamp(torch.amax(params_t[..., lay.signal_param_idx].abs(),
                                  dim=1), min=1e-6)
    bounds = _slot_bounds(lay, window, shape, (), con)
    inputs = dict(vect0=vect0.numpy(), const_params=params,
                  pixels=pixels.numpy(), mask=mask.numpy(),
                  origin=origin.numpy(), norm=norm.numpy(), valid=valid,
                  fvalid=None if con is not None else fvalid)
    kw = dict(model=model, layout=lay, window_shape=window,
              global_slots=_tied_slots(lay, con), bounds=bounds,
              max_iter=MAX_IT, constraint=con)
    return inputs, kw


_ARGS = ("vect0", "const_params", "pixels", "mask", "origin", "norm",
         "valid", "fvalid")


def _args(inputs, device="cpu"):
    return [None if inputs[k] is None else torch.as_tensor(inputs[k]).to(
        device) for k in _ARGS]


def _card(kw):
    """A bucket's keywords with its bounds on the card."""
    return dict(kw, bounds=kw["bounds"].to("cuda"))


def _jax_solve(inputs, kw, max_iter=MAX_IT):
    """The reference's lm_solve_global on the same inputs, with the
    closures its bucket solver builds (refine.py:256-300 for a rigid
    bucket's chain rule)."""
    import jax
    import jax.numpy as jnp

    from clustertracking_tpu.constraints import Constraint as JConstraint
    from clustertracking_tpu.constraints import pose_dim, pose_to_positions
    from clustertracking_tpu.models import build_layout as jax_layout
    from clustertracking_tpu.models import get_model as jax_model
    from clustertracking_tpu.ops.lm import lm_solve_global
    from clustertracking_tpu.ops.residual import make_model_fns as jax_fns

    lay, con = kw["layout"], kw["constraint"]
    jlay = jax_layout(jax_model(kw["model"].name), lay.ndim, lay.isotropic,
                      lay.n_features, dict(zip(lay.param_names, lay.modes)))
    np.testing.assert_array_equal(jlay.slot_idx, lay.slot_idx)
    fns = jax_fns(jax_model(kw["model"].name), jlay, tuple(
        kw["window_shape"]))
    a = {k: None if v is None else jnp.asarray(v) for k, v in inputs.items()}
    if con is None:
        residual, residual_jac = fns.residual, fns.residual_jac
        args = (a["const_params"], a["pixels"], a["mask"], a["origin"],
                a["norm"], a["fvalid"])
    else:
        jcon = JConstraint(**dataclasses.asdict(con))
        Qt = pose_dim(jcon) + int(jcon.fit_dist)
        n, D = lay.n_features, lay.ndim
        pos_idx = np.array(lay.pos_param_idx)
        pos_rows = np.array([lay.slot_idx[i, p] for i in range(n)
                             for p in lay.pos_param_idx])

        def params_of(vect, params_ref):
            pos = pose_to_positions(vect[:, :Qt], jcon)
            params = jlay.vect_to_params(vect[:, Qt:], params_ref)
            return params.at[..., pos_idx].set(pos)

        def residual(vect, params_ref, pixels, mask, origin, norm):
            img = fns.image_from_params(params_of(vect, params_ref), origin)
            return (img - pixels) * (mask / norm[:, None])

        pose_jac_one = jax.jacfwd(
            lambda p: pose_to_positions(p[None], jcon)[0])

        def residual_jac(vect, params_ref, pixels, mask, origin, norm):
            params = params_of(vect, params_ref)
            r, J_std = fns.residual_jac(jlay.vect_from_params(params),
                                        params, pixels, mask, origin, norm)
            G = jax.vmap(pose_jac_one)(vect[:, :Qt])
            Bd, _, Npx = J_std.shape
            Jpos = J_std[:, pos_rows, :].reshape(Bd, n, D, Npx)
            J_pose = jnp.einsum("bndq,bndp->bqp", G, Jpos,
                                precision=jax.lax.Precision.HIGHEST)
            J_free = J_std.at[:, pos_rows, :].set(0.0)
            return r, jnp.concatenate([J_pose, J_free], axis=1)

        args = (a["const_params"], a["pixels"], a["mask"], a["origin"],
                a["norm"])
    res = lm_solve_global(
        residual, residual_jac, a["vect0"], tuple(kw["global_slots"]),
        args, max_iter=max_iter, lower=jnp.asarray(kw["bounds"].lo.numpy()),
        upper=jnp.asarray(kw["bounds"].hi.numpy()), valid=a["valid"])
    return [np.asarray(v) for v in res[:4]]


# ------------------------------------------------------------------ routes

def test_kernel_route_takes_the_train_layouts_and_dimer_global():
    """'tied' for train_leastsq's inv_series_2 layouts (n = 1, 2) and a
    dimer_global() bucket in 2D (n-gon) and 3D (axis)."""
    model = get_model("inv_series_2")
    for n in (1, 2):
        lay = build_layout(model, 2, True, n, TRAIN_MODES)
        assert _uses_global(lay, None)
        assert kernel_route(model, lay, True, None, (14, 14)) == "tied"
    gauss = get_model("gauss")
    for ndim, window in ((2, (18, 18)), (3, (11, 13, 13))):
        con = dimer_global(ndim=ndim)
        lay = build_layout(gauss, ndim, True, 2, {})
        assert _uses_global(lay, con) and tie_supported(lay, con)
        assert kernel_route(gauss, lay, True, con, window) == "tied"


def test_kernel_route_leaves_what_the_kernel_does_not_take():
    """None (lm_solve_global) for a tied bucket of 20 kernel slots or more,
    a custom model, a generic constraint and a window past the cap."""
    model = get_model("inv_series_8")
    lay = build_layout(model, 2, True, 3, {"size": "var"})   # 3·4 + 8
    assert lay.n_slots == 20 and lay.global_slots.any()
    assert kernel_route(model, lay, True, None, (20, 20)) is None
    lay19 = build_layout(model, 2, False, 2, {
        "background": "cluster", "size_y": "var", "size_x": "var"})
    assert lay19.n_slots == 19   # 1 + 2·5 + 8
    assert kernel_route(model, lay19, True, None, (20, 20)) == "tied"
    custom = get_model({"name": "custom_tied", "params": ("a",),
                        "fun": lambda r2, a: torch.exp(-a * r2),
                        "default": {"a": 0.5},
                        "default_mode": {"a": "global"}})
    lay_c = build_layout(custom, 2, True, 2, {})
    assert lay_c.global_slots.any()
    assert kernel_route(custom, lay_c, True, None, (14, 14)) is None
    generic = Constraint("generic", 2, 2, None, fun=lambda p: p[0, :1])
    gl = build_layout(model, 2, True, 1, {})
    assert kernel_route(model, gl, True, generic, (14, 14)) is None
    assert kernel_route(model, gl, True, None, (600, 600)) is None


# ------------------------------------------------------------------ packing

@pytest.mark.parametrize("ndim,n,modes", [
    (2, 2, {}), (2, 3, {}), (3, 2, {}), (2, 2, {"background": "global"})])
def test_pack_tied_follows_the_shard_solvers_gslots(ndim, n, modes):
    """``SlotBounds`` puts _shard_solver's gslots into the kernel's compact
    vector (``tied``, built once): a rigid bucket's tied distance stays at
    Qt − 1, a tied model slot moves to its compact row, the compact bounds
    (``kernel``) follow their slots."""
    model = get_model("gauss")
    con = dimer_global(ndim=ndim) if n == 2 else dataclasses.replace(
        dimer_global(ndim=ndim), cluster_size=n, name="trimer_global")
    lay = build_layout(model, ndim, True, n, modes)
    window = (18,) * ndim
    gslots = _tied_slots(lay, con)
    bounds = _slot_bounds(lay, window, (64,) * ndim, (), con)
    lo, hi = bounds.lo.numpy(), bounds.hi.numpy()
    Qt, keep, drop, remap = rigid_kernel_slots(lay, con)
    assert bounds.tied(gslots) is bounds.tied(gslots)
    tied = bounds.tied(gslots).numpy()
    lo_k, hi_k = bounds.kernel.lo.numpy(), bounds.kernel.hi.numpy()
    assert gslots[Qt - 1] and gslots[keep].sum() == gslots.sum()
    want = [Qt - 1] + [int(remap[s]) for s in np.flatnonzero(
        lay.global_slots)]
    assert tied.tolist() == sorted(want)
    assert tied.dtype == np.int32
    np.testing.assert_array_equal(lo_k, lo[keep])
    np.testing.assert_array_equal(hi_k, hi[keep])
    # the distance's bounds at Qt − 1: the window's
    assert lo_k[Qt - 1] == lo[Qt - 1] and np.isfinite(hi_k[Qt - 1])
    # unconstrained: the mask's own slots, the bounds as they are
    lay_u = build_layout(get_model("inv_series_2"), 2, True, 2, TRAIN_MODES)
    bounds_u = _slot_bounds(lay_u, (14, 14), (64, 64))
    tied_u = bounds_u.tied(_tied_slots(lay_u, None))
    assert tied_u.tolist() == np.flatnonzero(lay_u.global_slots).tolist()
    assert bounds_u.kernel.lo is bounds_u.lo
    assert bounds_u.kernel.hi is bounds_u.hi


# ------------------------------------------------------------------ the plan

# [train]'s and [global]'s first tied launches (chip_smoke.py's
# _tied_bucket): lanes, kernel slots, tied, window, profile, pose
TRAIN_LAUNCH = (256, 5, 2, (14, 14), 4, 0)
GLOBAL_LAUNCH = (1472, 6, 1, (18, 18), 0, 1)


def _plan(B, V, G, window, prof, pose, **kw):
    return launch_plan(B, V, window, len(window), prof, pose, G, **kw)


@pytest.mark.parametrize("B", [1, 5, 40, 96, 192])
def test_plan_for_small_buckets(B):
    """A bucket of fewer lanes than the card has SMs takes a CTA a lane;
    up to 132 × 12, one lane a warp; every CTA has a warp for each joint
    sum (the cost, two g and three H entries, two maxima: 8) and keeps
    its lane state and pixel lists in shared memory."""
    for sms in (132, 114):
        plan = _plan(B, *TRAIN_LAUNCH[1:], sms=sms)
        ctas = min(B, sms)
        assert plan["ctas"] == ctas and plan["slot_ceiling"] == 8
        assert plan["warps"] == min(CTA_WARPS[8], max(-(-B // ctas), 8))
        assert plan["lanes_per_warp"] == 1
        assert plan["state_in_shared"] and plan["pool_words"] > 0


@pytest.mark.parametrize("launch", [TRAIN_LAUNCH, GLOBAL_LAUNCH])
def test_plan_spreads_the_workflows_buckets_over_the_card(launch):
    """[train]'s and [global]'s first tied launches (256 and 1,472 lanes)
    take one CTA on each of the card's 132 SMs, so that an SM runs two or
    twelve lanes at once (a thread-block cluster's 16 SMs, measured too,
    ran them 1.5× and 5× slower; PERF.md); a CTA has a warp for each of
    its lanes or of its joint sums (G = 2: 8, G = 1: 5)."""
    B = launch[0]
    plan = _plan(*launch)
    assert plan["ctas"] == 132 and plan["lanes_per_warp"] == 1
    G = launch[2]
    assert plan["warps"] == min(CTA_WARPS[8], max(-(-B // 132),
                                                  3 + G + G * (G + 1) // 2))
    assert plan["state_in_shared"] and plan["pool_words"] > 0


@pytest.mark.parametrize("B,ceiling,lanes", [
    (1584, 8, 1), (1585, 0, 1), (2112, 0, 1), (2200, 8, 2), (3168, 8, 2),
    (4096, 0, 2)])
def test_plan_strides_warps_over_lanes(B, ceiling, lanes):
    """Past one lane a warp (132 CTAs of 12 warps at slot ceiling 8),
    warps stride over lanes; the sweep stays the register one unless the
    tile's CTAs of 16 warps give a warp fewer lanes."""
    plan = _plan(B, *TRAIN_LAUNCH[1:])
    assert plan["ctas"] == 132 and plan["slot_ceiling"] == ceiling
    assert plan["warps"] == min(CTA_WARPS[ceiling], -(-B // 132))
    assert plan["lanes_per_warp"] == lanes == -(-B // (132 * plan["warps"]))
    reg = _plan(B, *TRAIN_LAUNCH[1:], ceiling=8)
    tile = _plan(B, *TRAIN_LAUNCH[1:], ceiling=0)
    assert tile["slot_ceiling"] == 0
    assert tile["warps"] == min(CTA_WARPS[0], -(-B // 132))
    assert min(reg["lanes_per_warp"], tile["lanes_per_warp"]) == lanes


@pytest.mark.parametrize("V,ceiling", [(5, 0), (5, 10), (9, 14), (9, 8),
                                       (15, 14), (5, 12)])
def test_plan_takes_a_ceiling_that_holds_the_slots(V, ceiling):
    """A slot ceiling asked for (to measure one sweep against another)
    is taken when it holds V slots, the tile always; a register ceiling
    below V, or one lm_core.cuh has no sweep for, raises."""
    args = (256, V, 2, (14, 14), 4, 0)
    if ceiling in CTA_WARPS and (ceiling == 0 or ceiling >= V):
        assert _plan(*args, ceiling=ceiling)["slot_ceiling"] == ceiling
    else:
        with pytest.raises(ValueError, match="slot ceiling"):
            _plan(*args, ceiling=ceiling)


@pytest.mark.parametrize("V", [1, 5, 8, 9, 10, 12, 14, 15, 19])
@pytest.mark.parametrize("ndim,window", [(2, (18, 18)), (2, (40, 40)),
                                         (3, (11, 13, 13)), (3, (21,) * 3)])
def test_plan_fits_shared_memory(V, ndim, window):
    """Every profile, pose and slot ceiling at up to 20,000 lanes and every
    tied count: a CTA's shared memory within the H100's 232,448 bytes and
    a multiple of 8 (FP64 and (offset, value) pairs stay aligned); the
    warps per CTA follow the ceiling and the lanes."""
    poses = (0, 1) if ndim == 2 else (0, 2, 3)
    for prof in range(5):
        for pose in poses:
            for G in sorted({1, V}):
                for B in (1, 256, 1472, 4096, 20000):
                    for ceiling in (None, 0):
                        plan = launch_plan(B, V, window, ndim, prof, pose,
                                           G, ceiling=ceiling)
                        vm = plan["slot_ceiling"]
                        assert vm in ({slot_ceiling(V), 0} if ceiling is None
                                      else {0})
                        assert plan["smem_bytes"] <= SMEM_MAX
                        assert plan["smem_bytes"] % 8 == 0
                        assert plan["pool_words"] % 2 == 0
                        assert plan["warps"] == min(
                            CTA_WARPS[vm],
                            max(-(-B // plan["ctas"]),
                                3 + G + G * (G + 1) // 2))
                        assert (plan["ctas"] * plan["warps"]
                                * plan["lanes_per_warp"] >= B)


def _fixed_order_sum(values, valid, plan):
    """csrc/tied_lm.cu's joint sum of one item, emulated in FP64: warp w
    of CTA c (gw = w·ctas + c) adds its valid lanes gw, gw + NW, ... in
    order; each CTA folds its warps' partials by a butterfly over 32
    lanes; every CTA adds the CTAs' partials k = l, l + 32, ... on lane l,
    then folds by a butterfly."""
    W, ctas = plan["warps"], plan["ctas"]
    NW = ctas * W
    v = np.where(valid, values.astype(np.float64), 0.0)
    warp = np.zeros(NW)
    for w in range(NW):
        s = 0.0
        for b in range(w, len(v), NW):
            if valid[b]:
                s += v[b]
        warp[w] = s

    def butterfly(lanes):
        idx = np.arange(32)
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[idx ^ o]
        assert np.all(lanes == lanes[0])   # every lane ends alike
        return lanes[0]

    cta = np.array([butterfly(np.concatenate(
        [warp[c::ctas], np.zeros(32 - W)])) for c in range(ctas)])
    lanes = np.zeros(32)
    for k in range(ctas):
        lanes[k % 32] += cta[k]
    return np.float32(butterfly(lanes))


@pytest.mark.parametrize("launch,ceiling", [
    (TRAIN_LAUNCH, None), (GLOBAL_LAUNCH, None), (GLOBAL_LAUNCH, 0),
    ((4096,) + TRAIN_LAUNCH[1:], None)])
def test_fixed_order_sums_round_as_the_plain_fp64_sum(launch, ceiling):
    """The kernel's fixed summation order, emulated on the CPU, gives the
    FP32 joint sums of the plain FP64 sum (math.fsum, rounded once) on a
    seeded bucket: per-lane costs, g entries of both signs and H entries
    of a bucket's size, its last lane invalid."""
    import math

    plan = _plan(*launch, ceiling=ceiling)
    rng = np.random.default_rng(14)
    B = launch[0]
    valid = np.ones(B, bool)
    valid[-1] = False
    items = [rng.lognormal(4.0, 1.0, B).astype(np.float32),
             rng.normal(0.0, 30.0, B).astype(np.float32),
             rng.lognormal(8.0, 2.0, B).astype(np.float32)]
    for x in items:
        want = np.float32(math.fsum(x[valid].astype(np.float64)))
        assert _fixed_order_sum(x, valid, plan) == want


# ------------------------------------------------------------------ checks

def _check_args(name="inv_series_2_n2"):
    """check_tied_lm_args's arguments for a small bucket (fvalid given)."""
    inputs, kw = _bucket(name, B=3)
    args = _args(inputs)
    args[7] = torch.ones_like(args[1][..., 0])
    kw = {k: v for k, v in kw.items() if k != "max_iter"}
    return args, kw


def _checked(which, bad):
    args, kw = _check_args()
    i = _ARGS.index(which)
    a = args[i]
    args[i] = {"shape": lambda: a[:-1] if a.dim() == 1 else a[:, :-1],
               "dtype": lambda: a.double() if a.is_floating_point()
               else a.to(torch.int64),
               "device": lambda: a.to("meta"),
               "layout": lambda: a.t().contiguous().t()}[bad]()
    return args, kw


def test_check_tied_lm_args_accepts_a_train_bucket():
    args, kw = _check_args()
    check_tied_lm_args(*args, **kw)


@pytest.mark.parametrize("which,bad,err", [
    ("vect0", "shape", ValueError), ("const_params", "dtype", TypeError),
    ("pixels", "shape", ValueError), ("mask", "dtype", TypeError),
    ("mask", "device", ValueError), ("origin", "dtype", TypeError),
    ("norm", "device", ValueError), ("valid", "dtype", TypeError),
    ("fvalid", "shape", ValueError), ("pixels", "layout", ValueError)])
def test_check_tied_lm_args_refuses(which, bad, err):
    args, kw = _checked(which, bad)
    with pytest.raises(err):
        check_tied_lm_args(*args, **kw)


def test_check_tied_lm_args_refuses_what_no_kernel_takes():
    args, kw = _check_args("inv_series_2_n1")
    with pytest.raises(ValueError, match="tied slot"):
        check_tied_lm_args(*args, **dict(
            kw, global_slots=np.zeros_like(kw["global_slots"])))
    generic = Constraint("generic", 1, 2, None, fun=lambda p: p[0, :1])
    with pytest.raises(ValueError, match="constraint"):
        check_tied_lm_args(*args, **dict(kw, constraint=generic))
    custom = get_model({"name": "custom_check",
                        "fun": lambda r2: torch.exp(-r2)})
    with pytest.raises(NotImplementedError):
        check_tied_lm_args(*args, **dict(kw, model=custom))


def test_wrapper_refuses_other_devices():
    inputs, kw = _bucket("inv_series_2_n1", B=2)
    args = [None if a is None else a.to("meta") for a in _args(inputs)]
    with pytest.raises(ValueError, match="unsupported device"):
        tied_lm(*args, **kw)


# ------------------------------------------------------- plain vs the reference

def _signal_slots(kw):
    """The signal slots of the solve vector (after a rigid pose)."""
    lay, con = kw["layout"], kw["constraint"]
    Qt = 0 if con is None else rigid_kernel_slots(lay, con)[0]
    return np.zeros(len(kw["global_slots"]), bool) | np.isin(
        np.arange(len(kw["global_slots"])),
        Qt + lay.slot_idx[:, lay.signal_param_idx])


def _assert_x(x, jx, kw, atol=X_ATOL):
    sig = _signal_slots(kw)
    np.testing.assert_allclose(x[:, ~sig], jx[:, ~sig], atol=atol, rtol=0)
    np.testing.assert_allclose(x[:, sig], jx[:, sig], rtol=X_SIGNAL_RTOL)


def _assert_matches(res, jres, kw, inputs):
    x, cost, n_iter, conv = (v.numpy() for v in res[:4])
    jx, jcost, jn_iter, jconv = jres
    npix = inputs["mask"].sum(1)
    floor = np.sqrt(jcost / np.maximum(npix, 1.0)) < RMS_FLOOR
    _assert_x(x, jx, kw, X_FLOOR_ATOL if floor.any() else X_ATOL)
    np.testing.assert_allclose(cost, jcost, rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(conv, jconv)
    tied = np.flatnonzero(kw["global_slots"])
    assert np.ptp(x[:, tied], axis=0).max() == 0.0


@pytest.mark.parametrize("name", list(BUCKETS))
def test_reference_matches_jax_lm_solve_global(name):
    """tied_lm_reference against the reference's lm_solve_global on the
    same inputs: the train layouts and the n-gon dimer_global bucket, with
    an invalid lane; n_iter equal on a solve cut at two iterations."""
    inputs, kw = _bucket(name)
    res = tied_lm_reference(*_args(inputs), **kw)
    np.testing.assert_array_equal(res.npix.numpy(), inputs["mask"].sum(1))
    _assert_matches(res, _jax_solve(inputs, kw), kw, inputs)
    assert not res.converged[-1] and res.n_iter[-1] == 0
    cut = tied_lm_reference(*_args(inputs), **dict(kw, max_iter=2))
    jcut = _jax_solve(inputs, kw, max_iter=2)
    np.testing.assert_array_equal(cut.n_iter.numpy(), jcut[2])
    _assert_x(cut.x.numpy(), jcut[0], kw)


def test_wrapper_on_cpu_returns_the_plain_version():
    inputs, kw = _bucket("dimer_global_ngon", B=4)
    before = tied_lm.launches
    res = tied_lm(*_args(inputs), **kw)
    ref = tied_lm_reference(*_args(inputs), **kw)
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    assert tied_lm.launches == before


def _train_scene():
    from test_train import _scene

    img, f = _scene(mixed=True, n_spots=9)
    f0 = f.copy()
    f0["y"] += 0.3
    f0["x"] -= 0.2
    return f0, img


def test_refine_tied_route_on_cpu_is_the_plain_route():
    """refine_leastsq(lm_backend='kernel') on the CPU takes the tied route
    through tied_lm's plain version: tagged cpu-tied-global and
    cpu-tied-rigid-global, every column bit-equal to lm_backend='torch'."""
    f0, img = _train_scene()
    kw = dict(diameter=11, separation=6, fit_function="inv_series_2",
              param_mode={"size": "const"}, device="cpu")
    cols = ["y", "x", "signal", "coeff_1", "coeff_2", "cost",
            "fit_converged", "fit_n_iter"]
    with diagnostics.collect() as stats:
        out_k = ctt.refine_leastsq(f0, img, lm_backend="kernel", **kw)
    out_t = ctt.refine_leastsq(f0, img, lm_backend="torch", **kw)
    assert sorted({b.backend for b in stats.batches}) == ["cpu-tied-global"]
    for c in cols:
        np.testing.assert_array_equal(out_k[c].to_numpy(),
                                      out_t[c].to_numpy())


def test_refine_dimer_global_tied_route_on_cpu_is_the_plain_route():
    from clustertracking_tpu_torch import artificial

    rng = np.random.default_rng(5)
    img = np.zeros((96, 96))
    rows = []
    for c in [(20, 20), (20, 70), (70, 20), (70, 70), (45, 45)]:
        true = artificial.draw_cluster(img, c, size=2.5, separation=5.0,
                                       n=2, signal=150.0,
                                       angle=rng.uniform(0, np.pi))
        rows.append(true + rng.uniform(-0.3, 0.3, true.shape))
    import pandas as pd

    f = pd.DataFrame(np.concatenate(rows), columns=["y", "x"])
    f["frame"] = 0
    kw = dict(diameter=9, separation=5.5, param_val={"size": 2.5},
              constraints=dimer_global(ndim=2), device="cpu")
    with diagnostics.collect() as stats:
        out_k = ctt.refine_leastsq(f, img, lm_backend="kernel", **kw)
    out_t = ctt.refine_leastsq(f, img, lm_backend="torch", **kw)
    tags = sorted({b.backend for b in stats.batches})
    assert "cpu-tied-rigid-global" in tags, tags
    assert out_k.attrs["global_dist"] == out_t.attrs["global_dist"]
    for c in ("y", "x", "signal", "cost", "fit_n_iter"):
        np.testing.assert_array_equal(out_k[c].to_numpy(),
                                      out_t[c].to_numpy())


# ------------------------------------------------------------------ the card

def _card_agree(res_k, res_p, kw, inputs, positions=True):
    """chip_smoke.py's gates for the tied kernel against its plain version:
    tied slots within rtol 1e-4, positions within 1e-3 px, per-lane cost
    within 1e-3 where rms ≥ 1e-5, converged equal on ≥ 99.9% of lanes,
    the joint cost within 1e-4.  ``positions=False``: a flat minimum, held
    by cost and converged only (ring fits, ROADMAP queue 3)."""
    lay, con = kw["layout"], kw["constraint"]
    valid = inputs["valid"]
    xk, xp = res_k.x.cpu().numpy(), res_p.x.cpu().numpy()
    tied = np.flatnonzero(kw["global_slots"])
    np.testing.assert_allclose(xk[:, tied], xp[:, tied], rtol=TIED_RTOL)
    if con is None:
        pos = sorted({int(s) for p in lay.pos_param_idx
                      for s in lay.slot_idx[:, p]})
        dpos = np.abs(xk[:, pos] - xp[:, pos])
    else:
        cfns = make_constrained_fns(kw["model"], lay, kw["window_shape"],
                                    con)
        cp = torch.as_tensor(inputs["const_params"])
        dpos = (cfns.positions_of(res_k.x.cpu(), cp)
                - cfns.positions_of(res_p.x.cpu(), cp)).abs().numpy()
    assert dpos.max() <= POS_ATOL or not positions
    ck, cp_ = res_k.cost.cpu().numpy(), res_p.cost.cpu().numpy()
    live = valid & (np.sqrt(cp_ / np.maximum(inputs["mask"].sum(1), 1))
                    >= RMS_FLOOR)
    np.testing.assert_allclose(ck[live], cp_[live], rtol=CARD_COST_RTOL)
    conv_k = res_k.converged.cpu().numpy()
    assert (conv_k == res_p.converged.cpu().numpy()).mean() >= 0.999
    jk, jp = ck[valid].astype(float).sum(), cp_[valid].astype(float).sum()
    assert abs(jk - jp) <= TIED_RTOL * jp


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BUCKETS))
def test_kernel_matches_plain_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs, kw = _bucket(name, B=40)
    args, kw = _args(inputs, "cuda"), _card(kw)
    before = tied_lm.launches
    res_k = tied_lm(*args, **kw)
    again = tied_lm(*args, **kw)
    torch.cuda.synchronize()
    assert tied_lm.launches == before + 2
    res_p = tied_lm_reference(*args, **kw)
    _card_agree(res_k, res_p, kw, inputs)
    for a, b in zip(res_k, again):
        assert torch.equal(a, b)


def _plan_on_the_card(B, kw):
    """``launch_plan`` of a bucket as the wrapper makes it on this card."""
    Vk, G, D, prof, pose = _plan_args(kw)
    return launch_plan(
        B, Vk, kw["window_shape"], D, prof, pose, G,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)


def _plan_args(kw):
    """(kernel slots, tied slots, rank, profile tag, pose kind) of a
    bucket's tied_lm keywords."""
    lay, con = kw["layout"], kw["constraint"]
    Vk = lay.n_slots if con is None else len(rigid_kernel_slots(lay,
                                                                con)[1])
    return (Vk, int(np.sum(kw["global_slots"])), lay.ndim,
            profile_tag(kw["model"]), pose_kind(lay, con))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 2200])
def test_kernel_strides_over_lanes_on_the_card(B):
    """One lane; a few; more lanes than the grid has warps (1,584 on an
    H100: 132 CTAs of 12 warps at this bucket's slot ceiling), so warps
    stride over several lanes between the grid's barriers.  (At 3,000 lanes this
    scene draws clusters whose fit runs away from its data, signals past
    1e5 with JᵀJ diagonals ~1e-12 of the lane's largest, where no two
    roundings agree.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs, kw = _bucket("inv_series_2_n2", B=max(B, 2))
    if B > 5:
        plan = _plan_on_the_card(B, kw)
        assert plan["lanes_per_warp"] > 1
    if B == 1:
        inputs = {k: None if v is None else v[:1] for k, v in inputs.items()}
        inputs["valid"] = np.ones(1, bool)
    args, kw = _args(inputs, "cuda"), _card(kw)
    res_k = tied_lm(*args, **kw)
    res_p = tied_lm_reference(*args, **kw)
    torch.cuda.synchronize()
    _card_agree(res_k, res_p, kw, inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["inv_series_2_n2", "dimer_global_ngon"])
def test_register_and_tile_sweeps_agree_on_the_card(name):
    """The same bucket through its slot ceiling's register sweep and
    through the tile (``tied_lm_clocks(ceiling=0)``, 16 warps a CTA): each
    held to the plain version, and the two to each other within
    chip_smoke.py's gates (their pixel sums add in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs, kw = _bucket(name, B=300)
    args, kw = _args(inputs, "cuda"), _card(kw)
    res_p = tied_lm_reference(*args, **kw)
    out = {}
    for ceiling in (None, 0):
        out[ceiling], clocks = tied_lm_clocks(*args, ceiling=ceiling, **kw)
        torch.cuda.synchronize()
        vm = tied_lm.last_plan["slot_ceiling"]
        assert vm == (slot_ceiling(_plan_args(kw)[0]) if ceiling is None
                      else 0)
        assert clocks.shape[0] == tied_lm.last_grid
        assert int(clocks[0, -1]) == int(tied_lm.last_iterations.item()) + 1
        _card_agree(out[ceiling], res_p, kw, inputs)
    _card_agree(out[None], out[0], kw, inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["ring", "hat", "disc", "gauss"])
def test_kernel_profiles_on_the_card(profile):
    """The other built-in profiles, their extra parameter tied (ring's
    thickness, hat's disc_size) or the size (disc, gauss)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    modes = {"ring": {"size": "const", "thickness": "global"},
             "hat": {"size": "const", "disc_size": "global"}}.get(
        profile, {"size": "global"})
    BUCKETS["_p"] = (profile, 2, 2, modes, None)
    try:
        inputs, kw = _bucket("_p", B=24)
    finally:
        del BUCKETS["_p"]
    assert kw["global_slots"].any()
    args, kw = _args(inputs, "cuda"), _card(kw)
    res_k = tied_lm(*args, **kw)
    res_p = tied_lm_reference(*args, **kw)
    torch.cuda.synchronize()
    _card_agree(res_k, res_p, kw, inputs, positions=profile != "ring")


@pytest.mark.cuda
def test_refine_dimer_global_on_the_card_takes_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clustertracking_tpu_torch import artificial
    import pandas as pd

    rng = np.random.default_rng(5)
    img = np.zeros((96, 96))
    rows = []
    for c in [(20, 20), (20, 70), (70, 20), (70, 70), (45, 45)]:
        true = artificial.draw_cluster(img, c, size=2.5, separation=5.0,
                                       n=2, signal=150.0,
                                       angle=rng.uniform(0, np.pi))
        rows.append(true + rng.uniform(-0.3, 0.3, true.shape))
    f = pd.DataFrame(np.concatenate(rows), columns=["y", "x"])
    f["frame"] = 0
    kw = dict(diameter=9, separation=5.5, param_val={"size": 2.5},
              constraints=dimer_global(ndim=2))
    before = tied_lm.launches
    with diagnostics.collect() as stats:
        out = ctt.refine_leastsq(f, img, device="cuda", **kw)
    out_c = ctt.refine_leastsq(f, img, device="cpu", **kw)
    assert tied_lm.launches > before
    assert "cuda-tied-rigid-global" in {b.backend for b in stats.batches}
    assert abs(out.attrs["global_dist"] - out_c.attrs["global_dist"]) < 1e-4
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               out_c[["y", "x"]].to_numpy(), atol=POS_ATOL)

