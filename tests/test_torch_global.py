"""Global ties in the port, held to the JAX package on the same numpy
inputs: ``lm_solve_global``, the global bucket route of
``refine_leastsq`` ('global' parameter modes), and the whole-video
distance of ``dimer_global()``.

Tolerances, float32 on both sides with sums in another order:

- ``lm_solve_global`` on tests/test_lm.py's three global-slot problems
  (1-D Gaussians with one amplitude shared by every lane): per-lane x
  within 1e-5 (on the noisy problem, 1e-4: there a joint cost that moves
  by one float32 ulp is accepted by one framework and not the other
  after convergence, and that step moves the noisiest lane's flat
  optimum by 5.7e-5 once two lanes are masked out; both stop at the same
  joint cost), cost within 1e-5 relative plus 4e-6 absolute (a
  residual of a few float32 ulps at |y| ≈ 5, summed over a lane's ≤ 1
  absolute residual: the noise-free lanes end at cost ~1e-13, where the
  relative part says nothing), converged equal on every lane, and n_iter
  equal on a solve cut at two iterations, before convergence (at
  convergence the plateau exit moves with rounding, ROADMAP queue 3).
  The port's Jacobian is ``torch.func.jacfwd``, the reference's
  ``jax.jacfwd``.
- ``refine_leastsq(fit_function='inv_series_2')`` with its default
  'global' coefficients: the learned coefficient columns within 1e-4,
  positions within 1e-3 px.
- tests/test_constraints.py's three ``dimer_global()`` cases:
  ``attrs['global_dist(s)']`` within 1e-4 px, positions within 1e-3 px,
  plus the reference's own ground-truth bounds.

The port runs on the CPU here (``device='cpu'``); the card test at the end
holds ``lm_solve_global`` on CUDA to the same call on the CPU.
"""
import functools

import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial, diagnostics
from clustertracking_tpu_torch.interop import constraint_from_reference
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.refine import kernel_route
from clustertracking_tpu_torch.ops.lm import lm_solve_global

# the port's entry points run on CUDA unless asked for the CPU
refine_cpu = functools.partial(ctt.refine_leastsq, device="cpu")
locate_cpu = functools.partial(ctt.locate, device="cpu")

torch.set_num_threads(1)

X_ATOL = 1e-5
X_FLOOR_ATOL = 1e-4
COST_RTOL = 1e-5
COST_ATOL = 4e-6
COEFF_ATOL = 1e-4
DIST_ATOL = 1e-4
POS_ATOL = 1e-3


def _gauss_problem(name):
    """tests/test_lm.py's global-slot problems (same seeds and shapes):
    (t, y, x0, kwargs).  Slot 0 (the amplitude) is shared."""
    rng = np.random.default_rng(1234)
    if name == "tying":
        B, npts = 6, 48
        t = np.linspace(0, 10, npts).astype(np.float32)
        m_true = rng.uniform(3, 7, B).astype(np.float32)
        y = 4.0 * np.exp(
            -((t[None] - m_true[:, None]) ** 2) / 2.0).astype(np.float32)
        x0 = np.stack([rng.uniform(2, 6, B),
                       m_true + rng.normal(0, 0.2, B)], -1).astype(np.float32)
        return t, y, x0, {}
    t = np.linspace(-2, 2, 32).astype(np.float32)
    if name == "per_lane_cost":
        B = 64
        m_true = rng.uniform(-0.5, 0.5, B).astype(np.float32)
        noise = (rng.normal(0, 0.05, (B, 32))
                 * np.linspace(0.2, 3.0, B)[:, None]).astype(np.float32)
        y = (5.0 * np.exp(-((t[None] - m_true[:, None]) ** 2) / 2.0)
             + noise).astype(np.float32)
        x0 = np.stack([np.full(B, 4.0),
                       m_true + rng.normal(0, 0.1, B)], -1).astype(np.float32)
        return t, y, x0, {}
    B = 17
    y = (5.0 * np.exp(-(t[None] ** 2) / 2.0)).astype(np.float32)
    y = np.repeat(y, B, axis=0)
    m0 = np.zeros(B, np.float32)
    m0[1::2] += 1.0
    m0[2::2] -= 1.0
    x0 = np.stack([np.full(B, 5.0), m0], -1).astype(np.float32)
    return t, y, x0, {"xtol": 1e-3}


def _solve_both(name, valid=None, **extra):
    import jax
    import jax.numpy as jnp

    from clustertracking_tpu.ops.lm import lm_solve_global as jax_solve

    t, y, x0, kw = _gauss_problem(name)
    kw.update(extra)

    def j_res(x, y):
        return x[:, 0:1] * jnp.exp(-((t[None] - x[:, 1:2]) ** 2) / 2.0) - y

    def j_jac(x, y):
        J = jax.jacfwd(lambda v: j_res(v, y))(x)
        return j_res(x, y), jnp.einsum("bnbv->bvn", J)

    tt = torch.from_numpy(t)

    def t_res(x, y):
        return x[:, 0:1] * torch.exp(-((tt[None] - x[:, 1:2]) ** 2) / 2.0) - y

    def t_jac(x, y):
        J = torch.func.vmap(torch.func.jacfwd(
            lambda v, yy: t_res(v[None], yy[None])[0]))(x, y)
        return t_res(x, y), J.transpose(1, 2)

    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    res_j = jax_solve(j_res, j_jac, jnp.asarray(x0), (True, False),
                      (jnp.asarray(y),), valid=jv, **kw)
    res_t = lm_solve_global(t_res, t_jac, torch.from_numpy(x0),
                            (True, False), (torch.from_numpy(y),), valid=tv,
                            **kw)
    return res_t, res_j


@pytest.mark.parametrize("name,with_invalid", [
    ("tying", False), ("per_lane_cost", False), ("per_lane_cost", True),
    ("lane_iters", False)])
def test_lm_solve_global_matches_jax(name, with_invalid):
    valid = None
    if with_invalid:
        valid = np.ones(64, bool)
        valid[[5, 40]] = False
    res_t, res_j = _solve_both(name, valid)
    np.testing.assert_allclose(
        res_t.x.numpy(), np.asarray(res_j.x), rtol=0,
        atol=X_FLOOR_ATOL if name == "per_lane_cost" else X_ATOL)
    np.testing.assert_allclose(res_t.cost.numpy(), np.asarray(res_j.cost),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))
    # every lane shares one amplitude
    assert np.ptp(res_t.x.numpy()[:, 0]) == 0.0
    # before convergence the per-lane iteration counts agree exactly
    cut_t, cut_j = _solve_both(name, valid, max_iter=2)
    np.testing.assert_array_equal(cut_t.n_iter.numpy(),
                                  np.asarray(cut_j.n_iter))
    np.testing.assert_allclose(cut_t.x.numpy(), np.asarray(cut_j.x),
                               atol=X_ATOL, rtol=0)


def test_lm_solve_global_reports_lane_cost_and_own_iterations():
    """The reference's own checks (tests/test_lm.py): per-lane cost is
    that lane's sum of squares, noisier lanes cost more, and a lane that
    starts at its optimum reports an early n_iter."""
    res, _ = _solve_both("per_lane_cost")
    t, y, _, _ = _gauss_problem("per_lane_cost")
    x = res.x.numpy()
    r = x[:, 0:1] * np.exp(-((t[None] - x[:, 1:2]) ** 2) / 2.0) - y
    np.testing.assert_allclose(res.cost.numpy(), (r ** 2).sum(axis=1),
                               rtol=1e-5, atol=1e-7)
    assert res.cost.numpy()[-8:].mean() > 10 * res.cost.numpy()[:8].mean()
    assert (res.n_iter.numpy() > 0).all() and res.converged.numpy().all()
    res, _ = _solve_both("lane_iters")
    it = res.n_iter.numpy()
    assert it[0] < it[1:].min(), it
    assert res.converged.numpy().all()


def test_global_buckets_take_no_kernel():
    """A bucket with a tied slot or a globally shared distance takes the
    tied route where csrc/tied_lm.cu takes it: kernel_route names 'tied'
    for train_leastsq's inv_series_2 layout.  A tied bucket of 20 kernel
    slots or more keeps no kernel route (lm_solve_global), and
    lm_backend='kernel' is refused for it."""
    model = get_model("inv_series_2")
    lay = build_layout(model, 2, True, 2, {"size": "const"})
    assert lay.global_slots.any()
    assert kernel_route(model, lay, True, None, (13, 13)) == "tied"
    big = get_model("inv_series_8")
    lay20 = build_layout(big, 2, True, 3, {"size": "var"})
    assert lay20.global_slots.any() and lay20.n_slots == 20
    assert kernel_route(big, lay20, True, None, (20, 20)) is None
    img = np.zeros((64, 64))
    pos = artificial.draw_cluster(img, (32, 32), size=2.0, separation=5.0,
                                  n=3, signal=180.0)
    f = pd.DataFrame(pos, columns=["y", "x"])
    f["frame"], f["signal"], f["size"] = 0, 180.0, 2.0
    with pytest.raises(ValueError, match="global-tied slots True"):
        refine_cpu(f, img, diameter=11, separation=6,
                   fit_function="inv_series_8", param_mode={"size": "var"},
                   lm_backend="kernel")


def _train_scene():
    from test_train import _scene

    img, f = _scene(mixed=True, n_spots=9)
    return f, img, dict(diameter=11, separation=6,
                        fit_function="inv_series_2",
                        param_mode={"size": "const"})


def test_refine_inv_series_default_global_modes_match_jax():
    """inv_series_2 with its default modes ties both coefficients across
    each dispatch (no NotImplementedError any more): the tied columns and
    the positions agree with the reference, and the dispatches are tagged
    cpu-torch-global."""
    import clustertracking_tpu as ct

    f, img, kw = _train_scene()
    f0 = f.copy()
    f0["y"] += 0.3
    f0["x"] -= 0.2
    out_j = ct.refine_leastsq(f0, img, **kw)
    with diagnostics.collect() as stats:
        out = refine_cpu(f0, img, **kw)
    assert sorted({b.backend for b in stats.batches}) == ["cpu-torch-global"]
    for c in ("coeff_1", "coeff_2"):
        np.testing.assert_allclose(out[c].to_numpy(), out_j[c].to_numpy(),
                                   atol=COEFF_ATOL, rtol=0)
        # one value per dispatch (a bucket of one cluster size)
        for _, grp in out.groupby("cluster_size"):
            assert np.ptp(grp[c].to_numpy()) == 0.0
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               out_j[["y", "x"]].to_numpy(), atol=POS_ATOL)
    assert out["cost"].notna().all()


def _both_global(f, frames, jcons, **kw):
    import clustertracking_tpu as ct

    out_j = ct.refine_leastsq(f, frames, constraints=jcons, **kw)
    with diagnostics.collect() as stats:
        out = refine_cpu(f, frames, constraints=[
            constraint_from_reference(c) for c in jcons], **kw)
    return out, out_j, sorted({b.backend for b in stats.batches})


def _dists(out, n):
    pos = out[out["cluster_size"] == n][["y", "x"]].to_numpy().reshape(
        -1, n, 2)
    return np.concatenate([
        np.linalg.norm(pos[:, i] - pos[:, j], axis=-1)
        for i in range(n) for j in range(i + 1, n)])


def test_dimer_global_learns_shared_distance():
    """tests/test_constraints.py::test_dimer_global_learns_shared_distance
    through both packages."""
    from clustertracking_tpu.constraints import dimer_global

    img = np.zeros((96, 96))
    rng = np.random.default_rng(5)
    all_true, f_rows = [], []
    for c in [(20, 20), (20, 70), (70, 20), (70, 70), (45, 45)]:
        true = artificial.draw_cluster(
            img, c, size=2.5, separation=5.0, n=2, signal=150.0,
            angle=rng.uniform(0, np.pi))
        all_true.append(true)
        f_rows.append(true + rng.uniform(-0.3, 0.3, true.shape))
    f = pd.DataFrame(np.concatenate(f_rows), columns=["y", "x"])
    f["frame"] = 0
    out, out_j, tags = _both_global(
        f, img, [dimer_global(ndim=2)], diameter=9, separation=5.5,
        param_val={"size": 2.5})
    assert tags == ["cpu-torch-rigid", "cpu-torch-rigid-global"]
    assert abs(out.attrs["global_dist"] - out_j.attrs["global_dist"]) \
        < DIST_ATOL
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               out_j[["y", "x"]].to_numpy(), atol=POS_ATOL)
    dists = _dists(out, 2)
    assert np.ptp(dists) < 1e-3
    assert abs(dists[0] - 5.0) < 0.02
    pos = out[["y", "x"]].to_numpy().reshape(-1, 2, 2)
    assert np.abs(pos - np.stack(all_true)).max() < 0.05


def test_global_distance_start_groups_rows_by_cluster():
    """locate → find_clusters → dimer_global, whose rows come brightest
    first, not in cluster order: the port starts the whole-video distance
    from each cluster's own bond and recovers the drawn one, as it does on
    rows sorted by cluster; the reference reshapes the rows as they come
    (clustertracking_tpu/refine.py:1603), starts from the distance
    between unrelated features and ends far from it.  The reference is
    left as it is (ROADMAP queue 3)."""
    import clustertracking_tpu as ct
    from clustertracking_tpu.constraints import dimer_global

    rng = np.random.default_rng(0)
    img = np.zeros((256, 256))
    for c in artificial.gen_nonoverlapping_locations(
            (256, 256), 16, separation=30, margin=15, rng=1):
        artificial.draw_cluster(img, c, size=1.6, separation=5.0, n=2,
                                signal=150.0, angle=rng.uniform(0, np.pi))
    img += rng.normal(0, 2.0, img.shape)
    f = locate_cpu(img, diameter=9, separation=6)
    f["frame"] = 0
    f = ctt.find_clusters(f, 6)
    assert (f["cluster_size"] == 2).sum() >= 20
    assert not f["cluster"].is_monotonic_increasing
    kw = dict(diameter=9, separation=6, param_val={"size": 1.6})
    con = constraint_from_reference(dimer_global(ndim=2))
    out = refine_cpu(f, img, constraints=con, **kw)
    ordered = refine_cpu(f.sort_values("cluster", kind="stable"), img,
                         constraints=con, **kw)
    assert abs(out.attrs["global_dist"] - ordered.attrs["global_dist"]) \
        < DIST_ATOL
    assert abs(out.attrs["global_dist"] - 5.0) < 0.02
    out_j = ct.refine_leastsq(f, img, constraints=dimer_global(2), **kw)
    assert abs(out_j.attrs["global_dist"] - 5.0) > 1.0


def test_dimer_global_whole_video_single_distance():
    """tests/test_constraints.py::test_dimer_global_whole_video_single_
    distance: two 2-frame dispatches, one clean and one noisy, end with
    one distance near the truth."""
    from clustertracking_tpu.constraints import dimer_global

    rng = np.random.default_rng(9)
    frames = np.zeros((4, 96, 96), np.float32)
    rows = []
    for t in range(4):
        centers = ([(20, 20), (20, 70), (70, 20), (70, 70)]
                   if t < 2 else [(45, 45)])
        for c in centers:
            true = artificial.draw_cluster(
                frames[t], c, size=2.5, separation=5.0, n=2, signal=150.0,
                angle=rng.uniform(0, np.pi))
            for p in true + rng.uniform(-0.3, 0.3, true.shape):
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 150.0})
        if t >= 2:
            frames[t] += rng.normal(0, 6.0, frames[t].shape
                                    ).astype(np.float32)
    f = pd.DataFrame(rows)
    out, out_j, _ = _both_global(
        f, frames, [dimer_global(ndim=2)], diameter=9, separation=5.5,
        param_val={"size": 2.5}, frames_per_dispatch=2)
    assert abs(out.attrs["global_dist"] - out_j.attrs["global_dist"]) \
        < DIST_ATOL
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               out_j[["y", "x"]].to_numpy(), atol=POS_ATOL)
    assert out["cost"].notna().all()
    dists = _dists(out, 2)
    assert np.ptp(dists) < 1e-3, dists
    assert abs(float(np.mean(dists)) - 5.0) < 0.05
    assert abs(out.attrs["global_dist"] - 5.0) < 0.05


def test_two_global_distance_constraints_coexist():
    """tests/test_constraints.py::test_two_global_distance_constraints_
    coexist: dimers and trimers each recover their own shared distance."""
    from clustertracking_tpu.constraints import Constraint as JConstraint
    from clustertracking_tpu.constraints import dimer_global

    rng = np.random.default_rng(12)
    frames = np.zeros((2, 128, 128), np.float32)
    rows = []
    for t in range(2):
        for n, d, centers in ((2, 5.0, [(20, 20), (20, 100), (100, 60)]),
                              (3, 6.5, [(64, 24), (100, 110)])):
            for c in centers:
                true = artificial.draw_cluster(
                    frames[t], c, size=2.5, separation=d, n=n,
                    signal=150.0, angle=rng.uniform(0, np.pi))
                for p in true + rng.uniform(-0.3, 0.3, true.shape):
                    rows.append({"frame": t, "y": p[0], "x": p[1],
                                 "signal": 150.0})
    f = pd.DataFrame(rows)
    trimer_global = JConstraint("rigid", 3, 2, None, dist_mode="global",
                                name="trimer_global")
    out, out_j, _ = _both_global(
        f, frames, [dimer_global(ndim=2), trimer_global], diameter=9,
        separation=7.5, param_val={"size": 2.5})
    gd, gd_j = out.attrs["global_dists"], out_j.attrs["global_dists"]
    assert sorted(gd) == sorted(gd_j) == [2, 3]
    for n in gd:
        assert abs(gd[n] - gd_j[n]) < DIST_ATOL, (gd, gd_j)
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               out_j[["y", "x"]].to_numpy(), atol=POS_ATOL)
    assert out["cost"].notna().all()
    assert abs(gd[2] - 5.0) < 0.05 and abs(gd[3] - 6.5) < 0.05, gd
    d2, d3 = _dists(out, 2), _dists(out, 3)
    assert np.ptp(d2) < 1e-3 and abs(d2.mean() - 5.0) < 0.05
    assert np.ptp(d3) < 1e-2 and abs(d3.mean() - 6.5) < 0.05


@pytest.mark.cuda
def test_lm_solve_global_on_the_card_matches_cpu():
    """lm_solve_global on CUDA tensors against the same call on the CPU
    (the einsums run in full float32: no TF32 on either side)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t, y, x0, kw = _gauss_problem("per_lane_cost")
    out = {}
    for dev in ("cpu", "cuda"):
        tt = torch.as_tensor(t, device=dev)

        def res(x, yy):
            return (x[:, 0:1] * torch.exp(-((tt[None] - x[:, 1:2]) ** 2)
                                          / 2.0) - yy)

        def jac(x, yy):
            e = torch.exp(-((tt[None] - x[:, 1:2]) ** 2) / 2.0)
            J = torch.stack([e, x[:, 0:1] * e * (tt[None] - x[:, 1:2])], 1)
            return res(x, yy), J

        out[dev] = lm_solve_global(
            res, jac, torch.as_tensor(x0, device=dev), (True, False),
            (torch.as_tensor(y, device=dev),), **kw)
    np.testing.assert_allclose(out["cuda"].x.cpu().numpy(),
                               out["cpu"].x.numpy(), atol=X_ATOL, rtol=0)
    np.testing.assert_allclose(out["cuda"].cost.cpu().numpy(),
                               out["cpu"].cost.numpy(), rtol=COST_RTOL,
                               atol=COST_ATOL)
