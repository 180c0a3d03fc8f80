"""The rigid-pose LM kernels: their plain versions vs the reference's
Pallas rigid kernels, the constrained bucket solver vs the reference's,
the routing of constrained buckets, and (on a card) kernel vs plain.

The plain rigid version (``fused_lm_2d_reference`` / ``pixel_lm_reference``
with ``constraint=``) solves the full [pose, std slots] vector through
``lm_solve`` with the chain-rule Jacobian of ``ops/rigid.py`` — the
reference's XLA rigid path — and is held to ``make_pallas_lm(...,
constraint=...)`` run as the JAX package's own tests run it on the CPU
(interpret mode): the 2D dimer through the fused-gather kernel, the 3D
dimer (axis pose) and the tetramer (rotation vector) through the
pixel-input kernel.  B=4, max_iter=6, scenes with noise σ=0.5 on signal
100 so no fit reaches the float32 floor (there the inlined trig and the
jacfwd chain rule round apart, tests/test_pallas_lm.py:363-368).
Tolerances: pose centers and angles, sizes 1e-4 absolute, signal and
cost 1e-4 relative, npix exactly; the inert position slots keep their
clipped start in both.

The bucket solvers are compared on small config 3 / 3b / 3c scenes
(``example_batch_rigid``, B=6, noise σ=1): positions 1e-4 px, signal 1e-4
relative, rms 1e-4 relative, converged exactly.

JAX is imported inside the parity tests only, so that the card-only tests
run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_rigid_lm.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch.constraints import (
    dimer, dimer_global, pose_to_positions, positions_to_pose, tetramer,
    trimer)
from clustertracking_tpu_torch.entry import (
    RIGID_CONFIGS, entry_rigid, example_batch_rigid)
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.ops.fused_lm import (
    fused_lm_2d, fused_lm_2d_reference, kernel_route)
from clustertracking_tpu_torch.ops.gather import gather_stack, origins_for
from clustertracking_tpu_torch.ops.pixel_lm import (
    pixel_lm, pixel_lm_reference)
from clustertracking_tpu_torch.ops.rigid import rigid_kernel_slots
from clustertracking_tpu_torch.refine import _bucket_solver, _slot_bounds

torch.set_num_threads(1)

MAX_IT = 6
ATOL = 1e-4
RTOL = 1e-4

# kind -> (constraint, frame shape, window, radius, size)
KINDS = {
    "2d_dimer": (lambda: dimer(5.0, 2), (64, 64), (13, 13), (4.5, 4.5),
                 2.0),
    "2d_trimer": (lambda: trimer(5.0, 2), (64, 64), (15, 15), (4.5, 4.5),
                  2.0),
    "3d_dimer": (lambda: dimer(5.0, 3), (24, 32, 32), (11, 13, 13),
                 (4.0, 5.0, 5.0), 2.0),
    "3d_tetramer": (lambda: tetramer(3.2), (24, 32, 32), (10, 10, 10),
                    (3.5, 3.5, 3.5), 1.5),
    "2d_dimer_fit_dist": (lambda: dimer_global(2, mode="cluster"),
                          (64, 64), (13, 13), (4.5, 4.5), 2.0),
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _scene(kind, B=4, seed=0, noise=0.5):
    make_con, shape, window, radius, size = KINDS[kind]
    con = make_con()
    n, D = con.cluster_size, con.ndim
    rng = np.random.default_rng(seed)
    lay = build_layout(get_model("gauss"), D, True, n, {})
    frames = np.zeros((B,) + shape, np.float32)
    params0 = np.zeros((B, n, lay.n_params), np.float32)
    truth = np.zeros((B, n, D))
    for b in range(B):
        center = np.asarray(shape, float) / 2 + rng.uniform(-1, 1, D)
        truth[b] = artificial.draw_cluster(
            frames[b], center, size=size, separation=5.0 if n < 4 else 3.2,
            n=n, signal=100.0, angle=rng.uniform(0, np.pi))
        params0[b, :, 1] = 100.0
        params0[b, :, 2:2 + D] = truth[b] + rng.uniform(-0.2, 0.2, (n, D))
        params0[b, :, 2 + D] = size
    frames += np.random.default_rng(seed + 1).normal(
        0.0, noise, frames.shape).astype(np.float32)
    pose0 = positions_to_pose(params0[:, :, 2:2 + D], con).astype(np.float32)
    return con, lay, frames, np.arange(B, dtype=np.int32), params0, pose0, \
        window, radius, truth


def _args(con, lay, frames, fidx, params0, pose0, window, radius, valid,
          gathered):
    vect0 = torch.cat([_t(pose0), lay.vect_from_params(_t(params0))], dim=1)
    pos = pose_to_positions(_t(pose0), con).contiguous()
    origin = origins_for(pos, window, frames.shape[1:])
    lo, hi = _slot_bounds(lay, window, frames.shape[1:], constraint=con)
    src = ((gather_stack(_t(frames), _t(fidx), origin, window),) if gathered
           else (_t(frames), _t(fidx)))
    args = (vect0, _t(params0), *src, pos, origin,
            _t(params0[..., 1].max(axis=1)), _t(valid), None)
    kw = dict(model=get_model("gauss"), layout=lay, window_shape=window,
              lo=lo, hi=hi, radius=radius, max_iter=MAX_IT, constraint=con)
    return args, kw


def _jax_constraint(con):
    """The reference's constraint of the same spec; interop carries it
    back into the port unchanged."""
    import clustertracking_tpu.constraints as jc

    from clustertracking_tpu_torch.interop import constraint_from_reference

    jcon = jc.Constraint(con.kind, con.cluster_size, con.ndim, con.dist,
                         con.dist_mode, name=con.name)
    assert constraint_from_reference(jcon) == con
    return jcon


def _pallas(lay, args, kw, fused, frame_shape):
    import jax.numpy as jnp

    from clustertracking_tpu.models import build_layout as jax_build_layout
    from clustertracking_tpu.models import get_model as jax_get_model
    from clustertracking_tpu.ops.pallas_lm import make_pallas_lm

    jlay = jax_build_layout(jax_get_model("gauss"), lay.ndim, True,
                            lay.n_features, {})
    solve = make_pallas_lm(
        jax_get_model("gauss"), jlay, kw["window_shape"], kw["lo"],
        kw["hi"], kw["radius"], max_iter=MAX_IT, interpret=True,
        fused_gather=fused, frame_shape=frame_shape,
        constraint=_jax_constraint(kw["constraint"]))
    assert solve.fused_gather == fused
    n_in = 8 if fused else 7
    return solve(*[jnp.asarray(a.numpy()) for a in args[:n_in]])


def _assert_matches(lay, con, res, jres, valid):
    """Pose, sizes and cost as the module docstring states; npix exactly.
    Converged flags and n_iter are not compared lane by lane: ftol fires
    on a relative cost change of 1.5e-8, below float32's resolution, so
    the iteration it fires at follows the Jacobian's rounding (the inlined
    trig vs the jacfwd chain rule), as in the reference's own kernel vs
    XLA rigid test (tests/test_pallas_lm.py:333-381), which compares
    neither."""
    Qt, keep, drop, _ = rigid_kernel_slots(lay, con)
    sig = [Qt + int(s) for s in lay.slot_idx[:, lay.signal_param_idx]]
    other = [k for k in keep if k not in sig]
    x, jx = res.x.numpy(), np.asarray(jres.x)
    np.testing.assert_allclose(x[:, other], jx[:, other], atol=ATOL, rtol=0)
    np.testing.assert_allclose(x[:, sig], jx[:, sig], rtol=RTOL, atol=0)
    np.testing.assert_array_equal(x[:, drop], jx[:, drop])
    np.testing.assert_allclose(res.cost.numpy()[valid],
                               np.asarray(jres.cost)[valid], rtol=RTOL)
    np.testing.assert_array_equal(res.npix.numpy()[valid],
                                  np.asarray(jres.npix)[valid])


@pytest.mark.parametrize("kind", ["2d_dimer", "2d_dimer_fit_dist"])
def test_fused_rigid_reference_matches_pallas(kind):
    """The 2D n-gon pose through the fused-gather kernel (the TPU's config
    3 hot path), fixed and fitted distance."""
    con, lay, frames, fidx, params0, pose0, window, radius, _ = _scene(kind)
    frames = np.pad(frames, ((0, 0), (0, 0), (0, 64)))
    valid = np.array([True, True, False, True])
    args, kw = _args(con, lay, frames, fidx, params0, pose0, window, radius,
                     valid, gathered=False)
    res = fused_lm_2d_reference(*args, **kw)
    jres = _pallas(lay, args, kw, True, frames.shape[1:])
    _assert_matches(lay, con, res, jres, valid)


@pytest.mark.parametrize("kind", ["3d_dimer", "3d_tetramer"])
def test_pixel_rigid_reference_matches_pallas(kind):
    """The 3D axis pose (dimer) and rotation-vector pose (tetramer)
    through the pixel-input kernel."""
    con, lay, frames, fidx, params0, pose0, window, radius, _ = _scene(kind)
    valid = np.ones(4, bool)
    args, kw = _args(con, lay, frames, fidx, params0, pose0, window, radius,
                     valid, gathered=True)
    res = pixel_lm_reference(*args, **kw)
    jres = _pallas(lay, args, kw, False, None)
    _assert_matches(lay, con, res, jres, valid)


def _bucket_inputs(config, B=6):
    frames, fidx, params0, pose0, valid = example_batch_rigid(config, B=B)
    frames = frames + np.random.default_rng(2).normal(
        0.0, 1.0, frames.shape).astype(np.float32)
    return frames, fidx, params0, pose0, valid


@pytest.mark.parametrize("config", RIGID_CONFIGS)
@pytest.mark.parametrize("lm_backend", ["auto", "kernel"])
def test_bucket_solver_matches_jax(config, lm_backend):
    """A rigid cell's bucket solver ('auto' = lm_solve on the CPU,
    'kernel' = the rigid kernel route's plain versions) vs the reference's
    XLA rigid path, on the cell's scene at B=6 with noise."""
    import jax.numpy as jnp

    from clustertracking_tpu.models.registry import get_model as jgm
    from clustertracking_tpu.refine import _bucket_solver as jax_solver
    from clustertracking_tpu_torch.entry import _rigid_configs

    c = _rigid_configs()[config]
    arrays = _bucket_inputs(config)
    args = (c["ndim"], True, c["con"].cluster_size, (), c["window"],
            c["radius"], (), None, 1e5, 10, 1.0, 60, 1.49e-8, 1.49e-8,
            False)
    solve, _ = entry_rigid(config, "cpu", batch=arrays,
                           lm_backend=lm_backend)[0], None
    jargs = args[:7] + (_jax_constraint(c["con"]),) + args[8:]
    jsolve, _ = jax_solver(jgm("gauss"), *jargs, "xla")
    out = solve(*[torch.as_tensor(a) for a in arrays])
    jout = [np.asarray(a) for a in jsolve(*[jnp.asarray(a)
                                            for a in arrays])]
    D = c["ndim"]
    np.testing.assert_allclose(out[0].numpy()[..., 2:2 + D],
                               jout[0][..., 2:2 + D], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[0].numpy()[..., 1], jout[0][..., 1],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(out[1].numpy(), jout[1], rtol=RTOL, atol=0)
    np.testing.assert_array_equal(out[2].numpy(), jout[2])


@pytest.mark.parametrize("kind,expect", [
    ("2d_dimer", "fused"), ("2d_trimer", "fused"),
    ("3d_dimer", "gathered"), ("3d_tetramer", "gathered"),
    ("2d_dimer_fit_dist", "fused"),
])
def test_kernel_route_takes_rigid_buckets(kind, expect):
    con, lay, _, _, _, _, window, _, _ = _scene(kind, B=1)
    assert kernel_route(get_model("gauss"), lay, False, con,
                        window) == expect


def test_kernel_route_sends_other_constraints_to_lm_solve():
    """Globally tied distances, generic penalties, positions that are not
    all fitted slots and 2D rigid windows too large to fuse take
    lm_solve, as pallas_available sends them to XLA."""
    from clustertracking_tpu_torch.constraints import wrap_constraint_dicts

    gauss = get_model("gauss")
    lay = build_layout(gauss, 2, True, 2, {})
    assert kernel_route(gauss, lay, False, dimer_global(2), (13, 13)) is None
    generic = wrap_constraint_dicts(
        {"type": "eq", "fun": lambda p: p[0, 0], "cluster_size": 2}, 2)[2]
    assert kernel_route(gauss, lay, False, generic, (13, 13)) is None
    lay_c = build_layout(gauss, 2, True, 2, {"x": "const"})
    assert kernel_route(gauss, lay_c, False, dimer(5.0, 2), (13, 13)) is None
    assert kernel_route(gauss, lay, False, dimer(5.0, 2), (200, 200)) is None


def test_rigid_kernel_slots_compact_layouts():
    """Config 3's compact lengths: 5 (dimer), 6 (trimer); 3b 7; 3c 10."""
    for config, vk in (("3-dimer", 5), ("3-trimer", 6), ("3b", 7),
                       ("3c", 10)):
        from clustertracking_tpu_torch.entry import _rigid_configs

        c = _rigid_configs()[config]
        lay = build_layout(get_model("gauss"), c["ndim"], True,
                           c["con"].cluster_size, {})
        Qt, keep, drop, remap = rigid_kernel_slots(lay, c["con"])
        assert len(keep) == vk
        assert len(drop) == c["ndim"] * c["con"].cluster_size
        assert sorted(keep + drop) == list(range(Qt + lay.n_slots))


def _agree(res_k, res_p, lay, con):
    """Kernel vs plain on the card: pose and positions 1e-3, cost 1e-3
    relative, npix equal, converged on ≥ 99.9% of lanes."""
    Qt = rigid_kernel_slots(lay, con)[0]
    xk, xp = res_k.x.cpu().numpy(), res_p.x.cpu().numpy()
    np.testing.assert_allclose(xk[:, :Qt], xp[:, :Qt], atol=1e-3, rtol=0)
    np.testing.assert_allclose(res_k.cost.cpu().numpy(),
                               res_p.cost.cpu().numpy(), rtol=1e-3)
    np.testing.assert_array_equal(res_k.npix.cpu().numpy(),
                                  res_p.npix.cpu().numpy())
    assert np.mean(res_k.converged.cpu().numpy()
                   == res_p.converged.cpu().numpy()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("kind,route", [
    ("2d_dimer", "fused"), ("2d_trimer", "fused"),
    ("2d_dimer_fit_dist", "fused"),
    ("3d_dimer", "resident"), ("3d_dimer", "streamed"),
    ("3d_tetramer", "resident"), ("3d_tetramer", "streamed"),
])
def test_kernel_matches_plain_on_the_card(kind, route):
    """csrc/fused_lm_2d.cu's n-gon pose and csrc/pixel_lm.cu's axis and
    rotation-vector poses vs their plain versions, B=128, 60 iterations,
    with frozen lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    con, lay, frames, fidx, params0, pose0, window, radius, _ = _scene(
        kind, B=128)
    valid = np.ones(128, bool)
    valid[::9] = False
    args, kw = _args(con, lay, frames, fidx, params0, pose0, window, radius,
                     valid, gathered=route != "fused")
    args = [a.to("cuda") if a is not None else None for a in args]
    kw["max_iter"] = 60
    if route == "fused":
        before = fused_lm_2d.launches
        res_k = fused_lm_2d(*args, **kw)
        assert fused_lm_2d.launches == before + 1
        res_p = fused_lm_2d_reference(*args, **kw)
    else:
        res_k = pixel_lm(*args, **kw, streaming=route == "streamed")
        res_p = pixel_lm_reference(*args, **kw)
    torch.cuda.synchronize()
    _agree(res_k, res_p, lay, con)
    # the inert position slots keep their clipped start
    drop = rigid_kernel_slots(lay, con)[2]
    np.testing.assert_array_equal(res_k.x.cpu().numpy()[:, drop],
                                  res_p.x.cpu().numpy()[:, drop])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["2d_dimer", "2d_trimer", "3d_dimer",
                                  "3d_tetramer", "2d_dimer_fit_dist"])
def test_refine_leastsq_rigid_kernels_on_the_card(kind):
    """refine_leastsq(constraints=...) on CUDA runs the rigid kernels and
    keeps the geometry: bond lengths to 1e-4 px (1e-3 for tetramer edges),
    and agrees with the plain route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pandas as pd

    from clustertracking_tpu_torch import diagnostics, refine_leastsq

    con, lay, frames, fidx, params0, _, window, radius, truth = _scene(
        kind, B=3)
    D = con.ndim
    cols = ["z", "y", "x"][3 - D:]
    rows = [dict(frame=b, signal=100.0, **dict(zip(cols, p[2:2 + D])))
            for b in range(3) for p in params0[b]]
    f = pd.DataFrame(rows)
    kw = dict(diameter=tuple(2 * r for r in radius), separation=6.0,
              constraints=con, param_val={"size": KINDS[kind][4]},
              device="cuda")
    with diagnostics.collect() as stats:
        out_k = refine_leastsq(f, frames, **kw)
    out_p = refine_leastsq(f, frames, lm_backend="torch", **kw)
    route = "fused" if D == 2 else "gathered"
    assert {b.backend for b in stats.batches} == {f"cuda-{route}-rigid"}
    pos = out_k[cols].to_numpy().reshape(3, con.cluster_size, D)
    np.testing.assert_allclose(pos, out_p[cols].to_numpy().reshape(pos.shape),
                               atol=1e-3)
    d = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
    off = d[:, ~np.eye(con.cluster_size, dtype=bool)]
    if con.dist is None:
        assert np.ptp(off, axis=1).max() < 1e-4
    else:
        np.testing.assert_allclose(off, con.dist,
                                   atol=1e-3 if con.cluster_size == 4
                                   else 1e-4)
