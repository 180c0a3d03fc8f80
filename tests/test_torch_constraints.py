"""The port's constraints (clustertracking_tpu_torch/constraints.py) and
constrained fits, held to the JAX package on the same numpy inputs.

- ``pose_to_positions`` and its ``jacfwd`` Jacobian vs the reference's
  (float32 on both sides): positions to 2e-5 px and Jacobian entries to
  2e-5 (a few float32 ulps at coordinates ~20 and radii ~3), for the 2D
  n-gon, the 3D dimer axis and the 3D rotation vector, including a
  rotation angle below 1e-3.
- ``positions_to_pose`` (host numpy on both sides) to 1e-9.
- The reference's tests/test_constraints.py cases through
  ``refine_leastsq`` in both packages (the port on the CPU: lm_solve):
  positions and sizes to 1e-3 px, bond lengths as the reference asserts
  them, plus the reference's own ground-truth bounds.
- What the port refuses: a ``mesh=`` that is not the port's ``Mesh``
  with a globally tied distance (``TypeError``; the distance runs,
  tests/test_torch_global.py, and under a mesh,
  tests/test_torch_parallel_fit.py) and a constraint of the wrong ndim.

Every constraint is built once, in the reference, and carried into the
port by ``interop.constraint_from_reference``.
"""
import functools

import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch import constraints as pc
from clustertracking_tpu_torch.interop import constraint_from_reference

# the port's refine_leastsq runs on CUDA unless asked for the CPU
refine_leastsq = functools.partial(ctt.refine_leastsq, device="cpu")

torch.set_num_threads(1)

POS_ATOL = 2e-5
FIT_ATOL = 1e-3


def _ref():
    import clustertracking_tpu.constraints as jc

    return jc


# name -> (reference constructor, pose [1, Q(+1)])
POSES = {
    "2d_trimer": (lambda jc: jc.trimer(5.0, ndim=2), [[20.0, 25.0, 0.7]]),
    "2d_dimer_fit_dist": (lambda jc: jc.dimer_global(ndim=2, mode="cluster"),
                          [[18.0, 21.0, -1.3, 4.6]]),
    "3d_dimer_axis": (lambda jc: jc.dimer(5.0, ndim=3),
                      [[12.0, 13.0, 11.0, 0.9, -0.4]]),
    "3d_tetramer_rotvec": (lambda jc: jc.tetramer(4.0),
                           [[12.0, 13.0, 11.0, 0.3, -0.5, 0.8]]),
    "3d_tetramer_small_angle": (lambda jc: jc.tetramer(3.2),
                                [[12.0, 13.0, 11.0, 4e-4, -3e-4, 2e-4]]),
    "3d_trimer_rotvec": (lambda jc: jc.trimer(5.0, ndim=3),
                         [[10.0, 9.0, 14.0, -1.1, 0.2, 2.4]]),
}


@pytest.mark.parametrize("name", list(POSES))
def test_pose_to_positions_and_jacobian_match_jax(name):
    import jax
    import jax.numpy as jnp

    jc = _ref()
    make, pose = POSES[name]
    jcon = make(jc)
    con = constraint_from_reference(jcon)
    pose = np.asarray(pose, np.float32)
    pos = pc.pose_to_positions(torch.as_tensor(pose), con).numpy()
    jpos = np.asarray(jc.pose_to_positions(jnp.asarray(pose), jcon))
    np.testing.assert_allclose(pos, jpos, atol=POS_ATOL, rtol=0)
    J = torch.func.jacfwd(
        lambda p: pc.pose_to_positions(p[None], con)[0])(
            torch.as_tensor(pose[0])).numpy()
    jJ = np.asarray(jax.jacfwd(
        lambda p: jc.pose_to_positions(p[None], jcon)[0])(
            jnp.asarray(pose[0])))
    assert J.shape == jJ.shape == pos.shape[1:] + pose.shape[1:]
    np.testing.assert_allclose(J, jJ, atol=POS_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(POSES))
def test_positions_to_pose_matches_jax_and_round_trips(name):
    jc = _ref()
    make, pose = POSES[name]
    jcon = make(jc)
    con = constraint_from_reference(jcon)
    rng = np.random.default_rng(3)
    pos = pc.pose_to_positions(torch.as_tensor(np.asarray(pose, np.float64)),
                               con).numpy()
    pos = pos + rng.uniform(-0.05, 0.05, pos.shape)
    mine = pc.positions_to_pose(pos, con)
    np.testing.assert_allclose(mine, jc.positions_to_pose(pos, jcon),
                               atol=1e-9, rtol=0)
    back = pc.pose_to_positions(torch.as_tensor(mine), con).numpy()
    assert np.abs(back - pos).max() < 0.15


def test_helpers_match_jax():
    jc = _ref()
    for n, d in ((2, 2), (3, 2), (4, 2), (2, 3), (3, 3), (4, 3)):
        assert pc.circumradius_factor(n, d) == jc.circumradius_factor(n, d)
        np.testing.assert_array_equal(pc.base_vertices(n, d),
                                      jc.base_vertices(n, d))
    for make in (lambda m: m.dimer(5.0, 2), lambda m: m.dimer(5.0, 3),
                 lambda m: m.trimer(5.0, 3), lambda m: m.tetramer(3.0),
                 lambda m: m.dimer_global(2, mode="cluster")):
        jcon = make(jc)
        con = constraint_from_reference(jcon)
        assert con == make(pc)
        assert pc.pose_dim(con) == jc.pose_dim(jcon)
        assert con.fit_dist == jcon.fit_dist


def test_constraint_from_reference_refuses_generic():
    jc = _ref()
    generic = jc.Constraint("generic", 2, 2, fun=lambda p: p[0, 0])
    with pytest.raises(ValueError, match="torch fun"):
        constraint_from_reference(generic)


def _frame2d(n, size, separation, angle, seed, noise=0.0):
    img = np.zeros((64, 64))
    true = artificial.draw_cluster(img, (32, 32), size=size,
                                   separation=separation, n=n, signal=200.0,
                                   angle=angle)
    if noise:
        img += np.random.default_rng(8).normal(0, noise, img.shape)
    rng = np.random.default_rng(seed)
    f = pd.DataFrame(true + rng.uniform(-0.4, 0.4, true.shape),
                     columns=["y", "x"])
    f["frame"] = 0
    return img, f, true


def _both(f, img, jcon, **kw):
    """refine_leastsq of both packages on the same inputs."""
    import clustertracking_tpu as ct

    out_j = ct.refine_leastsq(f, img, constraints=jcon, **kw)
    out = refine_leastsq(f, img, constraints=constraint_from_reference(jcon),
                         **kw)
    return out, out_j


def _edges(pos):
    d = np.linalg.norm(pos[None] - pos[:, None], axis=-1)
    return d[~np.eye(len(pos), dtype=bool)]


@pytest.mark.parametrize("n,size,angle,seed", [(2, 3.0, 0.8, 2),
                                               (3, 2.5, 0.4, 3)])
def test_constrained_ngon_fit_matches_jax(n, size, angle, seed):
    """tests/test_constraints.py's dimer and trimer fits."""
    jc = _ref()
    img, f, true = _frame2d(n, size, 5.0, angle, seed)
    jcon = jc.dimer(5.0, ndim=2) if n == 2 else jc.trimer(5.0, ndim=2)
    out, out_j = _both(f, img, jcon, diameter=9, separation=5.5,
                       param_val={"size": size})
    cols = ["y", "x", "size"]
    np.testing.assert_allclose(out[cols].to_numpy(), out_j[cols].to_numpy(),
                               atol=FIT_ATOL, rtol=0)
    pos = out[["y", "x"]].to_numpy()
    np.testing.assert_allclose(_edges(pos), 5.0, atol=1e-4)
    assert np.abs(pos - true).max() < 0.01


def test_constrained_tetramer_fit_3d_matches_jax():
    jc = _ref()
    img = np.zeros((28, 28, 28))
    true = artificial.draw_cluster(img, (14, 14, 14), size=1.8,
                                   separation=3.5, n=4, signal=150.0,
                                   angle=0.3)
    rng = np.random.default_rng(4)
    f = pd.DataFrame(true + rng.uniform(-0.3, 0.3, true.shape),
                     columns=["z", "y", "x"])
    f["frame"] = 0
    out, out_j = _both(f, img, jc.tetramer(3.5), diameter=7, separation=4.0,
                       param_val={"size": 1.8})
    cols = ["z", "y", "x"]
    np.testing.assert_allclose(out[cols].to_numpy(), out_j[cols].to_numpy(),
                               atol=FIT_ATOL, rtol=0)
    pos = out[cols].to_numpy()
    np.testing.assert_allclose(_edges(pos), 3.5, atol=1e-3)
    assert np.abs(pos - true).max() < 0.05


def test_dimer_global_cluster_mode_fits_per_cluster_distance():
    """dimer_global(mode='cluster'): one fitted bond length per cluster,
    rigid within it, close to the truth; agrees with the reference."""
    jc = _ref()
    img, f, true = _frame2d(2, 2.5, 5.0, 1.1, 6)
    out, out_j = _both(f, img, jc.dimer_global(ndim=2, mode="cluster"),
                       diameter=9, separation=5.5, param_val={"size": 2.5})
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               out_j[["y", "x"]].to_numpy(), atol=FIT_ATOL)
    pos = out[["y", "x"]].to_numpy()
    assert abs(np.linalg.norm(pos[0] - pos[1]) - 5.0) < 0.05
    assert np.abs(pos - true).max() < 0.02


def test_generic_constraint_dict_matches_jax():
    """A {'type': 'eq', 'fun': ...} dict becomes penalty rows in both
    packages (torch.linalg.norm in the port's fun, jnp.linalg.norm in the
    reference's)."""
    import clustertracking_tpu as ct
    import jax.numpy as jnp

    img, f, true = _frame2d(2, 3.0, 5.0, 0.8, 0)
    f[["y", "x"]] = true + 0.3
    kw = dict(diameter=9, separation=5.5, param_val={"size": 3.0})

    def spec(norm):
        return {"type": "eq", "args": (5.0,), "cluster_size": 2,
                "fun": lambda pos, target: norm(pos[0] - pos[1]) - target}

    out_j = ct.refine_leastsq(f, img, constraints=spec(jnp.linalg.norm), **kw)
    out = refine_leastsq(f, img, constraints=spec(torch.linalg.norm), **kw)
    pos = out[["y", "x"]].to_numpy()
    np.testing.assert_allclose(pos, out_j[["y", "x"]].to_numpy(),
                               atol=FIT_ATOL)
    assert np.linalg.norm(pos[0] - pos[1]) == pytest.approx(5.0, abs=1e-3)
    assert np.abs(pos - true).max() < 0.02


def test_constrained_compute_error_matches_jax():
    """compute_error under a rigid constraint: position stds by the delta
    method through the pose map, finite, positive, below 0.3 px, and
    within 2% of the reference's; signal std mapped directly."""
    jc = _ref()
    img, f, _ = _frame2d(2, 3.0, 5.0, 0.8, 9, noise=2.0)
    out, out_j = _both(f, img, jc.dimer(5.0, ndim=2), diameter=9,
                       separation=5.5, param_val={"size": 3.0},
                       compute_error=True)
    std = out["y_std"].to_numpy()
    assert np.isfinite(std).all() and (std > 0).all() and (std < 0.3).all()
    assert np.isfinite(out["signal_std"]).all()
    for c in ("y_std", "x_std", "signal_std"):
        np.testing.assert_allclose(out[c].to_numpy(), out_j[c].to_numpy(),
                                   rtol=2e-2)


def test_constraint_wrong_ndim_raises():
    with pytest.raises(ValueError):
        refine_leastsq(pd.DataFrame({"y": [1.0], "x": [1.0], "frame": [0]}),
                       np.zeros((16, 16)), diameter=5,
                       constraints=pc.dimer(3.0, ndim=3))


def _global_frame():
    img, f, true = _frame2d(2, 2.5, 5.0, 0.3, 1)
    kw = dict(diameter=9, separation=5.5, constraints=pc.dimer_global(ndim=2),
              param_val={"size": 2.5})
    return img, f, true, kw


def test_global_distance_raises_not_implemented():
    """dimer_global()'s whole-video distance runs on one device and under
    the port's ``Mesh``; a ``mesh`` of another kind raises ``TypeError``."""
    img, f, _, kw = _global_frame()
    with pytest.raises(TypeError, match="Mesh"):
        refine_leastsq(f, img, mesh=object(), **kw)


def test_global_distance_runs():
    """dimer_global()'s default ties one distance across the whole fit:
    it runs (lm_solve_global and the whole-video distance; held to the
    reference in tests/test_torch_global.py), fits the drawn bond and
    reports it in attrs."""
    img, f, true, kw = _global_frame()
    out = refine_leastsq(f, img, **kw)
    assert abs(out.attrs["global_dist"] - 5.0) < 0.02
    np.testing.assert_allclose(_edges(out[["y", "x"]].to_numpy()),
                               out.attrs["global_dist"], atol=1e-4)
    assert np.abs(out[["y", "x"]].to_numpy() - true).max() < 0.05


def _broad_dimer_frame(size, start):
    """A 2D dimer of ``size`` (a Gaussian wider than the fit window when
    large) with noise σ=0.5 and starts 0.4 px off, its size column at
    ``start``."""
    img, f, true = _frame2d(2, size, 5.0, 0.8, 2)
    img += np.random.default_rng(8).normal(0, 0.5, img.shape)
    f["size"] = start
    return img, f, true


def test_rigid_var_sizes_bounded_at_their_own_slots():
    """A rigid fit with sizes 'var' (``dimer(5.0, 2)`` in 2D), through
    both packages on the same inputs.

    The port bounds each fitted size to [0.05, largest window extent] at
    its own place in the rigid vector [pose (Qt = 3), slots (V = 8)],
    Qt + s (``refine._slot_bounds``).  The reference bounds the unshifted
    slot index s instead (clustertracking_tpu/refine.py:415-421 against
    the pose shift of :382-402): for this layout the size slots 6 and 7
    land on vector entries 6 and 7, which are layout slots 3 and 4, the
    inert position slots of feature 1's y and feature 0's x, and the
    fitted sizes (entries 9 and 10) are left unbounded.  On a well-posed
    scene (size 2.5, started at 2.0) the two agree.  On a dimer broader
    than its 18×18 window (size 30, started at 12) the port's sizes stop
    at the bound, 18, while the reference's run past it."""
    from clustertracking_tpu_torch.models import build_layout, get_model
    from clustertracking_tpu_torch.refine import _slot_bounds, _window_shape

    jc = _ref()
    layout = build_layout(get_model("gauss"), 2, True, 2, {"size": "var"})
    window = _window_shape(2, 2, (4.5, 4.5), (5.5, 5.5), (64, 64))
    assert window == (18, 18)
    bounds = _slot_bounds(layout, window, (64, 64),
                          constraint=pc.dimer(5.0, 2))
    lo, hi = bounds.lo.numpy(), bounds.hi.numpy()
    Qt = 3
    size_slots = [int(s) for s in
                  layout.slot_idx[:, layout.param_names.index("size")]]
    assert size_slots == [6, 7]
    for s in size_slots:
        assert (lo[Qt + s], hi[Qt + s]) == (np.float32(0.05), 18.0)
        # the entries the reference bounds: inert position slots, free here
        assert (lo[s], hi[s]) == (-np.inf, np.inf)

    kw = dict(diameter=9, separation=5.5, param_mode={"size": "var"})
    img, f, true = _broad_dimer_frame(2.5, 2.0)
    out, out_j = _both(f, img, jc.dimer(5.0, ndim=2), **kw)
    cols = ["y", "x", "size"]
    np.testing.assert_allclose(out[cols].to_numpy(), out_j[cols].to_numpy(),
                               atol=FIT_ATOL, rtol=0)
    assert np.abs(out["size"].to_numpy() - 2.5).max() < 0.01

    img, f, _ = _broad_dimer_frame(30.0, 12.0)
    out, out_j = _both(f, img, jc.dimer(5.0, ndim=2), **kw)
    np.testing.assert_allclose(out["size"].to_numpy(), 18.0, rtol=0,
                               atol=1e-5)
    assert (out_j["size"].to_numpy() > 18.0).all()
    pos = out[["y", "x"]].to_numpy()
    np.testing.assert_allclose(_edges(pos), 5.0, atol=1e-4)
