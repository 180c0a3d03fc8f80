"""Port parity: window origins, masks, residual/Jacobian and the batched
LM solver, torch vs JAX on the same numpy inputs (float32, CPU).

Origins and masks are integer/threshold results and must agree exactly.
The residual and Jacobian agree to float32 rounding (atol 1e-5 on values
of order 1).  ``lm_solve`` runs the same algorithm with sums taken in
another order; over ``MAX_IT`` iterations (before any lane reaches its
float32 noise floor) positions agree to 1e-4 px, signal and cost to
1e-4 relative, and n_iter and converged exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clustertracking_tpu import artificial as jax_artificial
from clustertracking_tpu.models import build_layout as jax_build_layout
from clustertracking_tpu.models import get_model as jax_get_model
from clustertracking_tpu.ops.gather import origins_for as jax_origins_for
from clustertracking_tpu.ops.gather import radius_mask as jax_radius_mask
from clustertracking_tpu.ops.lm import _damped_solve as jax_damped_solve
from clustertracking_tpu.ops.lm import lm_solve as jax_lm_solve
from clustertracking_tpu.ops.residual import make_model_fns as jax_make_fns
from clustertracking_tpu.ops.residual import window_offsets as jax_offsets
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.ops.gather import (
    gather_stack, origins_for, radius_mask)
from clustertracking_tpu_torch.ops.lm import damped_solve, lm_solve
from clustertracking_tpu_torch.ops.residual import (
    make_model_fns, window_offsets)

torch.set_num_threads(1)

MAX_IT = 6
POS_ATOL = 1e-4
RTOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("shape", [(9, 9), (13, 13), (5, 7, 7)])
def test_window_offsets_exact(shape):
    np.testing.assert_array_equal(
        window_offsets(shape).numpy(), np.asarray(jax_offsets(shape))
    )


@pytest.mark.parametrize("ndim,window,frame", [
    (2, (13, 13), (64, 64)),
    (2, (9, 13), (40, 64)),
    (3, (7, 9, 9), (24, 32, 32)),
])
def test_origins_for_exact(ndim, window, frame):
    rng = np.random.default_rng(ndim)
    pos = rng.uniform(-3, max(frame) + 3, (64, 2, ndim)).astype(np.float32)
    # exact .5 centers exercise round-half-to-even on both sides
    pos[:8] = np.round(pos[:8]) + np.float32(0.5) * (np.arange(8) % 2)[
        :, None, None]
    got = origins_for(_t(pos), window, frame)
    want = jax_origins_for(jnp.asarray(pos), window, frame)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ndim,window,radius", [
    (2, (13, 13), (4.5, 4.5)),
    (2, (9, 9), (3.0, 3.0)),
    (3, (7, 9, 9), (2.5, 3.5, 3.5)),
])
def test_radius_mask_exact(ndim, window, radius):
    rng = np.random.default_rng(7)
    n, B = 3, 32
    pos = rng.uniform(10, 14, (B, n, ndim)).astype(np.float32)
    frame = (24,) * ndim
    origin = jax_origins_for(jnp.asarray(pos), window, frame)
    fvalid = (rng.uniform(size=(B, n)) > 0.3).astype(np.float32)
    got = radius_mask(_t(pos), _t(np.asarray(origin)), window, radius,
                      fvalid=_t(fvalid))
    want = jax_radius_mask(jnp.asarray(pos), origin, window, radius,
                           fvalid=jnp.asarray(fvalid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_stack_matches_slicing():
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(3, 20, 30)).astype(np.float32)
    fidx = np.array([0, 2, 1, 2], np.int32)
    origin = np.array([[0, 0], [5, 17], [11, 3], [8, 21]], np.int32)
    got = gather_stack(_t(frames), _t(fidx), _t(origin), (9, 9)).numpy()
    for b in range(4):
        y, x = origin[b]
        np.testing.assert_array_equal(
            got[b], frames[fidx[b], y:y + 9, x:x + 9].ravel()
        )


RESIDUAL_CASES = [
    ("gauss", 2, True, 1, {}, False),
    ("gauss", 2, True, 2, {}, True),
    ("gauss", 2, True, 2, {"size": "var", "background": "cluster"}, False),
    ("gauss", 2, False, 2, {"size_y": "var", "size_x": "var"}, False),
    ("ring", 2, True, 1, {"thickness": "cluster"}, False),
    ("gauss", 3, False, 2, {"size_z": "var", "size_y": "var",
                            "size_x": "var"}, False),
]


def _residual_inputs(name, ndim, iso, n, modes, with_fvalid, seed=0):
    model, jmodel = get_model(name), jax_get_model(name)
    lay = build_layout(model, ndim, iso, n, modes)
    jlay = jax_build_layout(jmodel, ndim, iso, n, modes)
    window = (9,) * ndim
    rng = np.random.default_rng(seed)
    B = 6
    params = np.zeros((B, n, lay.n_params), np.float32)
    params[..., 0] = 3.0
    params[..., 1] = rng.uniform(80, 120, (B, n))
    params[..., 2:2 + ndim] = rng.uniform(3, 5, (B, n, ndim))
    nsz = 1 if iso else ndim
    params[..., 2 + ndim:2 + ndim + nsz] = rng.uniform(1.5, 2.5, (B, n, nsz))
    for j, nm in enumerate(model.extra_params):
        params[..., 2 + ndim + nsz + j] = model.default[nm]
    pixels = rng.uniform(0, 100, (B, int(np.prod(window)))).astype(
        np.float32)
    origin = np.zeros((B, ndim), np.int32)
    mask = (rng.uniform(size=pixels.shape) > 0.2).astype(np.float32)
    norm = params[..., 1].max(axis=1)
    fvalid = None
    if with_fvalid:
        fvalid = np.ones((B, n), np.float32)
        fvalid[::2, -1] = 0.0
    return (model, jmodel, lay, jlay, window, params, pixels, mask, origin,
            norm, fvalid)


@pytest.mark.parametrize("name,ndim,iso,n,modes,with_fvalid", RESIDUAL_CASES)
def test_residual_and_jacobian_match_jax(name, ndim, iso, n, modes,
                                         with_fvalid):
    (model, jmodel, lay, jlay, window, params, pixels, mask, origin, norm,
     fvalid) = _residual_inputs(name, ndim, iso, n, modes, with_fvalid)
    fns = make_model_fns(model, lay, window)
    jfns = jax_make_fns(jmodel, jlay, window)
    v = lay.vect_from_params(_t(params))
    jv = jlay.vect_from_params(jnp.asarray(params))
    extra = () if fvalid is None else (_t(fvalid),)
    jextra = () if fvalid is None else (jnp.asarray(fvalid),)
    args = (_t(params), _t(pixels), _t(mask), _t(origin), _t(norm)) + extra
    jargs = tuple(map(jnp.asarray, (params, pixels, mask, origin, norm))) \
        + jextra
    r = fns.residual(v, *args)
    r2, J = fns.residual_jac(v, *args)
    jr = jfns.residual(jv, *jargs)
    jr2, jJ = jfns.residual_jac(jv, *jargs)
    assert J.shape == tuple(jJ.shape)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-5, rtol=0)
    img = fns.image_from_params(_t(params), _t(origin))
    jimg = jfns.image_from_params(jnp.asarray(params), jnp.asarray(origin))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-6,
                               atol=1e-4)


def _lm_problem(name, n, modes, seed=0, B=4, window=(9, 9)):
    """test_pallas_lm.py's scene — B perturbed clusters on 64×64 frames —
    with Gaussian noise (sigma 1 on signal 100), so each fit's minimum
    lies far above float32 resolution: a noiseless fit ends at a cost of
    ~5e-12, where cost is rounding noise and no relative tolerance holds.
    """
    jmodel = jax_get_model(name)
    lay = build_layout(get_model(name), 2, True, n, modes)
    jlay = jax_build_layout(jmodel, 2, True, n, modes)
    rng = np.random.default_rng(seed)
    frames = np.zeros((B, 64, 64), np.float32)
    params0 = np.zeros((B, n, lay.n_params), np.float32)
    for b in range(B):
        center = np.array([32.0, 32.0]) + rng.uniform(-1, 1, 2)
        true = jax_artificial.draw_cluster(
            frames[b], center, size=1.8, separation=4.0, n=n,
            signal=100.0, angle=rng.uniform(0, np.pi),
        )
        params0[b, :, 1] = 100.0
        params0[b, :, 2:4] = true + rng.uniform(-0.2, 0.2, true.shape)
        params0[b, :, 4] = 1.8
        for j, nm in enumerate(jmodel.extra_params):
            params0[b, :, 5 + j] = jmodel.default[nm]
    frames += rng.normal(0.0, 1.0, frames.shape).astype(np.float32)
    pos0 = params0[..., 2:4]
    origin = np.asarray(jax_origins_for(jnp.asarray(pos0), window,
                                        (64, 64)))
    pixels = np.stack([
        frames[b, origin[b, 0]:origin[b, 0] + window[0],
               origin[b, 1]:origin[b, 1] + window[1]].ravel()
        for b in range(B)
    ])
    mask = np.asarray(jax_radius_mask(jnp.asarray(pos0), jnp.asarray(origin),
                                      window, (3.0, 3.0)))
    norm = params0[..., 1].max(axis=1)
    lo = np.full(lay.n_slots, -np.inf, np.float32)
    hi = np.full(lay.n_slots, np.inf, np.float32)
    for p in lay.pos_param_idx:
        for s in lay.slot_idx[:, p]:
            lo[s], hi[s] = 0.0, 63.0
    return (lay, jlay, window, params0, pixels, mask, origin, norm, lo, hi)


def _assert_lm_close(res, jres, lay):
    pos_slots = sorted({int(s) for p in lay.pos_param_idx
                        for s in lay.slot_idx[:, p]})
    other = [s for s in range(lay.n_slots) if s not in pos_slots]
    x, jx = res.x.numpy(), np.asarray(jres.x)
    np.testing.assert_allclose(x[:, pos_slots], jx[:, pos_slots],
                               atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(x[:, other], jx[:, other], rtol=RTOL, atol=0)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=RTOL, atol=0)
    np.testing.assert_array_equal(res.n_iter.numpy(),
                                  np.asarray(jres.n_iter))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))


LM_CASES = [
    ("gauss", 1, {}),
    ("gauss", 2, {}),
    ("ring", 1, {"thickness": "cluster"}),
]


def _solve_both(name, n, modes, max_iter):
    (lay, jlay, window, params0, pixels, mask, origin, norm, lo,
     hi) = _lm_problem(name, n, modes)
    fns = make_model_fns(get_model(name), lay, window)
    jfns = jax_make_fns(jax_get_model(name), jlay, window)
    valid = np.array([True, True, False, True])
    res = lm_solve(
        fns.residual, fns.residual_jac, lay.vect_from_params(_t(params0)),
        (_t(params0), _t(pixels), _t(mask), _t(origin), _t(norm)),
        max_iter=max_iter, lower=_t(lo), upper=_t(hi), valid=_t(valid),
    )
    jres = jax_lm_solve(
        jfns.residual, jfns.residual_jac,
        jlay.vect_from_params(jnp.asarray(params0)),
        tuple(map(jnp.asarray, (params0, pixels, mask, origin, norm))),
        max_iter=max_iter, lower=jnp.asarray(lo), upper=jnp.asarray(hi),
        valid=jnp.asarray(valid),
    )
    # the frozen lane keeps its (clipped) start
    np.testing.assert_array_equal(
        res.x.numpy()[2], lay.vect_from_params(_t(params0)).numpy()[2]
    )
    return res, jres, lay


@pytest.mark.parametrize("name,n,modes", LM_CASES)
def test_lm_solve_matches_jax(name, n, modes):
    res, jres, lay = _solve_both(name, n, modes, MAX_IT)
    _assert_lm_close(res, jres, lay)


@pytest.mark.parametrize("name,n,modes", LM_CASES)
def test_lm_solve_converged_matches_jax(name, n, modes):
    """Run to convergence (60 iterations): the minimum's cost and the
    converged flags agree; gauss positions agree to 1e-4 px.  n_iter is
    not compared here: the plateau exit counts rejected trials whose cost
    differs from the current one by a few ulps, so the two frameworks'
    rounding shifts it by a few iterations (ROADMAP queue 3), and the
    ring fit's flat minimum leaves positions 1e-3 px apart."""
    res, jres, lay = _solve_both(name, n, modes, 60)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=RTOL, atol=0)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    if name == "gauss":
        pos_slots = sorted({int(s) for p in lay.pos_param_idx
                            for s in lay.slot_idx[:, p]})
        np.testing.assert_allclose(
            res.x.numpy()[:, pos_slots], np.asarray(jres.x)[:, pos_slots],
            atol=POS_ATOL, rtol=0,
        )


def _spd_batch(B, V, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, V, V + 3)).astype(np.float32)
    H = np.einsum("bij,bkj->bik", A, A).astype(np.float32)
    g = rng.normal(size=(B, V)).astype(np.float32)
    lam = np.full(B, 1e-3, np.float32)
    return H, g, lam


@pytest.mark.parametrize("V", [3, 6, 19])
def test_damped_solve_unrolled_matches_direct(V):
    H, g, lam = _spd_batch(16, V, V)
    got = damped_solve(_t(H), _t(g), _t(lam)).numpy()
    d = np.maximum(np.diagonal(H, axis1=1, axis2=2), 1e-12)
    A = H.astype(np.float64) + (lam[:, None] * d)[:, None, :] * np.eye(V) \
        + 1e-10 * np.eye(V)
    want = -np.linalg.solve(A, g[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_damped_solve_library_path_marks_non_spd_lanes():
    """V > 20 uses cholesky_ex: a non-positive-definite lane gets NaN (its
    trial is rejected) instead of raising, as JAX's Cholesky does."""
    V = 24
    H, g, lam = _spd_batch(4, V, 1)
    H[1] = -np.eye(V, dtype=np.float32)
    out = damped_solve(_t(H), _t(g), _t(lam)).numpy()
    assert np.isnan(out[1]).all()
    assert np.isfinite(out[[0, 2, 3]]).all()
    jax_out = np.asarray(jax.jit(jax_damped_solve)(
        jnp.asarray(H), jnp.asarray(g), jnp.asarray(lam)))
    np.testing.assert_allclose(out[[0, 2, 3]], jax_out[[0, 2, 3]],
                               rtol=1e-3, atol=1e-4)
