"""Multi-device fits in the port (``parallel/sharding.py``,
``ops/collectives.py``, ``refine_leastsq`` / ``train_leastsq`` /
``track`` with ``mesh=``), held to the JAX package on the same numpy
inputs.

The port's mesh is ``make_mesh(["cpu"] * 4)`` (four shards on the host);
the JAX one is ``make_mesh(jax.devices()[:4])`` on the conftest's virtual
CPU devices.  The scenes are those of tests/test_sharded_api.py and
tests/test_sharded_pallas.py.  What has to agree:

- ``sharded_fit``: equal to the port's unsharded solver; positions
  within 2e-5 px of JAX's sharded fit, n_iter equal and
  ``compute_error``'s std per lane within 1e-4 where the noise-free
  scene's rms is above float32 rounding;
- ``refine_leastsq(mesh=)``: every column within rtol/atol 1e-5 of JAX's
  ``refine_leastsq(mesh=)`` and ``fit_converged`` equal, for free, rigid
  and tied buckets; on untied buckets every lane equal to the port's
  single-device result; a tied slot identical on every lane of every
  shard (ptp < 1e-5), within 1e-4 of JAX's and of one device's;
- ``track(mesh=)`` (single-shot and checkpointed) and
  ``train_leastsq(mesh=)`` as their single-device tests hold them;
- the collective: fixed-order, bit-equal from run to run.

The card tests split four shards over ``cuda:0`` and hold them to one
device on the card, lane for lane.
"""
import functools

import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial, diagnostics
from clustertracking_tpu_torch.entry import dryrun_multichip, example_batch
from clustertracking_tpu_torch.models.registry import get_model
from clustertracking_tpu_torch.ops.lm import (
    GlobalShard, lm_solve_global, lm_solve_global_shards)
from clustertracking_tpu_torch.parallel import (
    Mesh, all_reduce, fit_step_spec, make_mesh, sharded_fit)
from clustertracking_tpu_torch.refine import _bucket_solver

torch.set_num_threads(1)

CPU4 = ["cpu"] * 4
WINDOW = (9, 9)
refine_cpu = functools.partial(ctt.refine_leastsq, device="cpu")


def _jax_mesh():
    import jax

    from clustertracking_tpu.parallel.sharding import make_mesh as jmake

    return jmake(jax.devices()[:4])


def _dimer_video(T=4, shape=(80, 80), seed=0):
    """tests/test_sharded_api.py::_dimer_video."""
    rng = np.random.default_rng(seed)
    rows = []
    centers = np.array([[20.0, 20.0], [20.0, 60.0], [60.0, 40.0]])
    angles = np.array([0.3, 1.2, 2.0])
    for t in range(T):
        for k in range(len(centers)):
            u = np.array([np.sin(angles[k]), np.cos(angles[k])])
            for s in (1, -1):
                p = centers[k] + s * 2.5 * u
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 200.0})
        centers += rng.normal(0, 0.3, centers.shape)
        angles += rng.normal(0, 0.05, angles.shape)
    truth = pd.DataFrame(rows)
    return truth, artificial.CoordinateReader(truth, shape, size=2.0)


def _perturbed(truth, seed=7):
    rng = np.random.default_rng(seed)
    f = truth.copy()
    f[["y", "x"]] += rng.uniform(-0.3, 0.3, (len(f), 2))
    return f.drop(columns=["signal"])


# --- the mesh and the collective -------------------------------------------

def test_mesh():
    mesh = make_mesh(CPU4)
    assert isinstance(mesh, Mesh)
    assert mesh.size == 4 and mesh.shape == {"data": 4}
    assert mesh.axis_names == ("data",)
    assert [str(d) for d in mesh.devices.reshape(-1)] == CPU4
    assert mesh.distinct == [torch.device("cpu")]
    assert make_mesh(["cuda"], axis="x").devices[0] == torch.device("cuda",
                                                                     0)
    assert fit_step_spec(mesh) == ((), ("data",), ("data",), ("data",),
                                   ("data",))
    with pytest.raises(ValueError):
        fit_step_spec(mesh, axis="model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def test_all_reduce_fixed_order():
    """The sum is taken in shard order on the first shard's device, the
    same tensor comes back to every shard on that device, and a list of
    one is returned as it is."""
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.normal(size=5).astype(np.float32) * 10.0
                             ** k) for k in range(4)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    out = all_reduce(parts)
    assert all(o is out[0] for o in out)
    assert torch.equal(out[0], want)
    assert torch.equal(all_reduce(parts, op="max")[2],
                       torch.stack(parts).amax(dim=0))
    assert all_reduce(parts[:1])[0] is parts[0]


def test_lm_solve_global_shards():
    """One shard is lm_solve_global bit for bit; four shards solve the same
    joint problem (the tie identical on every lane, x within 1e-5) and two
    runs are bit-equal."""
    rng = np.random.default_rng(3)
    B, N = 16, 40
    t = torch.linspace(-1.0, 1.0, N)
    a = torch.as_tensor(rng.uniform(0.5, 2.0, B).astype(np.float32))
    y = a[:, None] * torch.exp(-1.3 * t[None] ** 2) \
        + torch.as_tensor(rng.normal(0, 0.01, (B, N)).astype(np.float32))

    def rj(x, y):
        e = torch.exp(-x[:, 1:2] * t[None] ** 2)
        r = x[:, 0:1] * e - y
        J = torch.stack([e, -x[:, 0:1] * t[None] ** 2 * e], dim=1)
        return r, J

    def res(x, y):
        return rj(x, y)[0]

    x0 = torch.tensor([[1.0, 1.0]]).repeat(B, 1)
    valid = torch.ones(B, dtype=torch.bool)
    valid[-3:] = False
    g = [False, True]
    one = lm_solve_global(res, rj, x0, g, (y,), valid=valid, max_iter=30)
    single = lm_solve_global_shards([GlobalShard(res, rj, x0, (y,), None,
                                                 None, valid)], g,
                                    max_iter=30)[0]
    for u, v in zip(one[:4], single[:4]):
        assert torch.equal(u, v)

    def sharded():
        shards = [GlobalShard(res, rj, x0[s:s + 4], (y[s:s + 4],), None,
                              None, valid[s:s + 4]) for s in range(0, B, 4)]
        return lm_solve_global_shards(shards, g, max_iter=30)

    runs = [sharded(), sharded()]
    x = torch.cat([r.x for r in runs[0]])
    assert torch.equal(x, torch.cat([r.x for r in runs[1]]))
    assert float(x[:, 1].max() - x[:, 1].min()) == 0.0
    np.testing.assert_allclose(x.numpy(), one.x.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(torch.cat([r.n_iter for r in runs[0]]), one.n_iter)
    assert torch.equal(torch.cat([r.converged for r in runs[0]]),
                       one.converged)


# --- sharded_fit ---------------------------------------------------------

@pytest.mark.parametrize("compute_error", [False, True])
@pytest.mark.parametrize("lm_backend", ["auto", "kernel"])
def test_sharded_fit_matches_unsharded_and_jax(lm_backend, compute_error):
    """tests/test_sharded_pallas.py's two cases: B=8 in shards of 2, the
    port's sharded fit against its unsharded solver (each shard runs the
    same per-lane arithmetic: equal) and against JAX's sharded fit
    (positions within 2e-5 px, every slot within rtol 1e-5, n_iter equal
    where the rms is above the rounding floor); with compute_error, the std
    per lane, equal to the unsharded solver's, within rtol 1e-4 of JAX's
    where the rms is above 1e-4, and differing lane to lane."""
    from clustertracking_tpu.parallel.sharding import (
        sharded_fit as ref_sharded_fit)

    batch = example_batch(B=8, frame_size=128, grid_pitch=16)
    kw = dict(lm_max_iter=6, max_iter=1, compute_error=compute_error)
    fit, layout = sharded_fit(make_mesh(CPU4), "gauss", 2, True, 2, WINDOW,
                              (4.5, 4.5), lm_backend=lm_backend, **kw)
    out = fit(*batch)
    solver, _ = _bucket_solver(
        get_model("gauss"), 2, True, 2, (), WINDOW, (4.5, 4.5), (), None,
        1e5, 1, 1.0, 6, 1.49e-8, 1.49e-8, compute_error, lm_backend)
    one = solver(*(torch.as_tensor(a) for a in batch))
    for k in range(4):
        assert torch.equal(out[k], one[k]), k
    ref_fit, _ = ref_sharded_fit(_jax_mesh(), "gauss", 2, True, 2, WINDOW,
                                 (4.5, 4.5), **kw)
    ref = [np.asarray(o) for o in ref_fit(*batch)]
    # positions to 2e-5 px; the signal (~150, whose float32 ulp is 1.5e-5)
    # and the rest relatively
    np.testing.assert_allclose(out[0][..., 2:4].numpy(), ref[0][..., 2:4],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=1e-5, atol=2e-5)
    # n_iter where the cost is above rounding: lane 7 is noise-free and
    # ends at rms 5e-7, where the reference's own routes part (its XLA
    # route stops two iterations before its kernel, which the port
    # matches); the 1e-5 floor is chip_smoke.py's RMS_FLOOR
    above = ref[1] >= 1e-5
    assert above.sum() == 7
    np.testing.assert_array_equal(out[3].numpy()[above], ref[3][above])
    if compute_error:
        std = out[4].numpy()
        assert std.shape == ref[4].shape == (8, 2, 5)
        np.testing.assert_array_equal(std, one[4].numpy())
        # the scene is noise-free: the std scales with the rms, which is
        # float32 rounding of a 150-signal model on lanes below 1e-4,
        # where the two frameworks' roundings part by up to 1e-2 of it
        clear = ref[1] >= 1e-4
        assert clear.sum() == 4
        np.testing.assert_allclose(std[clear], ref[4][clear], rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(std, ref[4], rtol=1e-2, atol=1e-7)
        assert np.ptp(std[:, 0, 2]) > 0
    else:
        assert out[4].shape == (0,)


# --- refine_leastsq(mesh=) -----------------------------------------------

REFINE = {
    "free": dict(diameter=7, separation=6.0, param_val={"size": 2.0}),
    "rigid": dict(diameter=7, separation=6.0, param_val={"size": 2.0},
                  constraints="dimer"),
    "free_errors": dict(diameter=7, separation=6.0,
                        param_val={"size": 2.0}, compute_error=True),
}


@pytest.mark.parametrize("case", sorted(REFINE))
def test_refine_mesh_matches_jax_and_one_device(case):
    """tests/test_sharded_api.py::test_refine_mesh_matches_single_device,
    and a rigid bucket (``dimer(5.0)``): the port's mesh against JAX's
    mesh (rtol/atol 1e-5, converged equal) and against the port on one
    device (equal: untied lanes are independent).  Every dispatch is
    tagged ``-sharded``."""
    import clustertracking_tpu as ct

    truth, reader = _dimer_video()
    f = _perturbed(truth)
    kw = dict(REFINE[case])
    kw_j = dict(kw)
    if kw.get("constraints") == "dimer":
        kw["constraints"], kw_j["constraints"] = ctt.dimer(5.0), ct.dimer(5.0)
    with diagnostics.collect() as stats:
        out = ctt.refine_leastsq(f, reader, mesh=make_mesh(CPU4), **kw)
    tags = {b.backend for b in stats.batches}
    assert tags and all(t.endswith("-sharded") for t in tags), tags
    assert {b.n_lanes for b in stats.batches} == {32}
    ref = ct.refine_leastsq(f, reader, mesh=_jax_mesh(), **kw_j)
    one = refine_cpu(f, reader, **kw)
    cols = ["y", "x", "signal", "size", "cost"]
    if kw.get("compute_error"):
        cols += ["y_std", "x_std"]
    for col in cols:
        np.testing.assert_allclose(out[col].to_numpy(), ref[col].to_numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=col)
        np.testing.assert_array_equal(out[col].to_numpy(),
                                      one[col].to_numpy(), err_msg=col)
    assert (out["fit_converged"] == ref["fit_converged"]).all()
    assert (out["fit_n_iter"] == one["fit_n_iter"]).all()


@pytest.mark.parametrize("shards", [4, 3])
def test_refine_mesh_global_tie_across_shards(shards):
    """tests/test_sharded_api.py::test_refine_mesh_global_tie_across_devices:
    the size tied across every lane of every shard (ptp < 1e-5), its value
    within 1e-4 of JAX's mesh and of the port on one device, two runs on
    the same mesh bit-equal; the tag is ``cpu-torch-global-sharded``.  Three
    shards pad the lanes to lcm(32, 3) = 96, as the reference does."""
    import clustertracking_tpu as ct

    truth, reader = _dimer_video(T=4)
    f = _perturbed(truth, seed=3)
    kw = dict(diameter=7, separation=6.0, param_mode={"size": "global"},
              param_val={"size": 2.2}, frames_per_dispatch=4)
    mesh = make_mesh(["cpu"] * shards)
    with diagnostics.collect() as stats:
        out = ctt.refine_leastsq(f, reader, mesh=mesh, **kw)
    assert {b.backend for b in stats.batches} == {
        "cpu-torch-global-sharded"}
    assert {b.n_lanes for b in stats.batches} == {32 if shards == 4 else 96}
    again = ctt.refine_leastsq(f, reader, mesh=mesh, **kw)
    pd.testing.assert_frame_equal(out, again)
    sizes = out.loc[out["cost"].notna(), "size"].to_numpy()
    assert sizes.size
    assert np.ptp(sizes) < 1e-5
    ref = ct.refine_leastsq(f, reader, mesh=_jax_mesh(), **kw)
    one = refine_cpu(f, reader, **kw)
    for other in (ref, one):
        np.testing.assert_allclose(
            sizes.mean(), other.loc[other["cost"].notna(), "size"].mean(),
            rtol=1e-4)
        np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                                   other[["y", "x"]].to_numpy(), atol=1e-4)


def test_refine_mesh_dimer_global():
    """``dimer_global()`` under a mesh: the per-dispatch fits tie the
    distance across shards (``cpu-torch-rigid-global-sharded``), the
    pooled Newton runs on one device and the fixed-distance refits take
    the mesh; the distance within 1e-4 of JAX's mesh and of one device."""
    import clustertracking_tpu as ct

    truth, reader = _dimer_video(T=4)
    f = _perturbed(truth, seed=5)
    kw = dict(diameter=7, separation=6.0, param_val={"size": 2.0})
    with diagnostics.collect() as stats:
        out = ctt.refine_leastsq(f, reader, mesh=make_mesh(CPU4),
                                 constraints=ctt.dimer_global(ndim=2), **kw)
    tags = {b.backend for b in stats.batches}
    assert {"cpu-torch-rigid-global-sharded", "cpu-torch-rigid-sharded"} \
        <= tags, tags
    ref = ct.refine_leastsq(f, reader, mesh=_jax_mesh(),
                            constraints=ct.dimer_global(ndim=2), **kw)
    one = refine_cpu(f, reader, constraints=ctt.dimer_global(ndim=2), **kw)
    for other in (ref, one):
        np.testing.assert_allclose(out.attrs["global_dist"],
                                   other.attrs["global_dist"], rtol=1e-4)
        np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                                   other[["y", "x"]].to_numpy(), atol=1e-4)


def test_entry_points_refuse_what_is_not_a_mesh():
    truth, reader = _dimer_video(T=1)
    f = _perturbed(truth)
    for call in (lambda: refine_cpu(f, reader, diameter=7, mesh="cpu"),
                 lambda: ctt.train_leastsq(f, reader, diameter=7,
                                           mesh=_jax_mesh()),
                 lambda: ctt.track(reader, diameter=7, mesh=[0, 1]),
                 lambda: ctt.link(truth, 3.0, mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()


# --- track and train with mesh= -----------------------------------------

TRACK = dict(diameter=7, separation=6.0, search_range=2.0,
             param_val={"size": 2.0}, threshold=20.0)


def _partition(ids):
    _, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv]


@pytest.mark.parametrize("checkpointed", [False, True])
def test_track_mesh_matches_jax(checkpointed, tmp_path):
    """tests/test_sharded_api.py::test_track_mesh_end_to_end through both
    packages' ``track(mesh=)`` on the 6-frame dimer video: the same rows
    and trajectories, positions within 1e-4 px of JAX's and equal to the
    port's single-device run, the truth within 0.01 px; checkpointed in
    3-frame chunks (the host Linker) as well."""
    import clustertracking_tpu as ct
    from scipy.spatial import cKDTree

    truth, reader = _dimer_video(T=6)
    kw = dict(TRACK)
    if checkpointed:
        kw.update(checkpoint_every=3)
    ck = {} if not checkpointed else {"checkpoint_dir": str(tmp_path / "a")}
    with diagnostics.collect() as stats:
        out = ctt.track(reader, mesh=make_mesh(CPU4), **kw, **ck)
    assert all(b.backend.endswith("-sharded") for b in stats.batches)
    ckj = {} if not checkpointed else {"checkpoint_dir": str(tmp_path / "b")}
    ref = ct.track(reader, mesh=_jax_mesh(), **kw, **ckj)
    cko = {} if not checkpointed else {"checkpoint_dir": str(tmp_path / "c")}
    one = ctt.track(reader, device="cpu", **kw, **cko)
    if not checkpointed:
        assert out.attrs["link_backend"] == ref.attrs["link_backend"] \
            == "sharded:device"
    assert len(out) == len(ref) == len(truth)
    np.testing.assert_array_equal(out["frame"], ref["frame"])
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               ref[["y", "x"]].to_numpy(), atol=1e-4)
    np.testing.assert_array_equal(out[["y", "x"]].to_numpy(),
                                  one[["y", "x"]].to_numpy())
    for col in ("particle", "cluster"):
        np.testing.assert_array_equal(_partition(out[col].to_numpy()),
                                      _partition(ref[col].to_numpy()))
    assert out["particle"].nunique() == 6
    assert (out.groupby("particle").size() == 6).all()
    for t in range(6):
        got = out[out["frame"] == t][["y", "x"]].to_numpy()
        want = truth[truth["frame"] == t][["y", "x"]].to_numpy()
        assert cKDTree(want).query(got)[0].max() < 0.01


def _train_scene(seed=3):
    """tests/test_train.py's scene, 12 singles drawn with 1 / (1 + 0.8 r²
    + 0.25 r⁴)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((160, 160))
    rows = []
    grid = [(y, x) for y in range(25, 140, 28) for x in range(25, 140, 28)]
    rng.shuffle(grid)
    for center in grid[:12]:
        p = np.asarray(center, float) + rng.uniform(-3, 3, 2)
        artificial.draw_feature(
            img, p, 2.0, 180.0,
            lambda r2: 1.0 / (1.0 + 0.8 * r2 + 0.25 * r2 * r2),
            cutoff_sigmas=8.0)
        rows.append({"frame": 0, "y": p[0], "x": p[1], "signal": 180.0,
                     "size": 2.0})
    return img, pd.DataFrame(rows)


def test_train_mesh_matches_jax():
    """train_leastsq(mesh=): the refits' tie all-reduces across the shards
    (``cpu-torch-global-sharded``); the learned coefficients within 1e-3
    of JAX's mesh and of one device, and within 0.05 of the truth."""
    import clustertracking_tpu as ct

    img, f = _train_scene()
    kw = dict(diameter=11, separation=6, fit_function="inv_series_2",
              param_mode={"size": "const"})
    with diagnostics.collect() as stats:
        learned = ctt.train_leastsq(f, img, mesh=make_mesh(CPU4), **kw)
    assert {b.backend for b in stats.batches} == {
        "cpu-torch-global-sharded"}
    ref = ct.train_leastsq(f, img, mesh=_jax_mesh(), **kw)
    one = ctt.train_leastsq(f, img, device="cpu", **kw)
    for other in (ref, one):
        assert sorted(learned) == sorted(other)
        for k in learned:
            assert abs(learned[k] - other[k]) < 1e-3, (k, learned, other)
    assert abs(learned["coeff_1"] - 0.8) < 0.05
    assert abs(learned["coeff_2"] - 0.25) < 0.05


def test_dryrun_multichip_on_the_host(capsys):
    res = dryrun_multichip(4, device="cpu")
    assert res["shards"] == 4 and res["distinct_devices"] == 1
    assert res["size_ptp"] < 1e-5 and res["trajectories"] == 6
    assert res["frames"] == 16
    assert "dryrun_multichip OK: 4 shards on 1 distinct" in \
        capsys.readouterr().out


# --- on the card -------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["free", "rigid"])
def test_refine_mesh_on_the_card_equals_one_device(case):
    """Four shards on cuda:0 (fused_lm_2d per shard) against one device on
    the card: every lane bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d

    truth, reader = _dimer_video()
    f = _perturbed(truth)
    kw = dict(REFINE[case])
    if kw.get("constraints") == "dimer":
        kw["constraints"] = ctt.dimer(5.0)
    before = fused_lm_2d.launches
    out = ctt.refine_leastsq(f, reader, mesh=make_mesh(["cuda:0"] * 4), **kw)
    assert fused_lm_2d.launches - before >= 4
    one = ctt.refine_leastsq(f, reader, device="cuda", **kw)
    pd.testing.assert_frame_equal(out, one)


@pytest.mark.cuda
def test_refine_mesh_tie_on_the_card():
    """The tie across four shards on cuda:0: identical on every lane, two
    runs bit-equal, within 1e-4 of one device on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    truth, reader = _dimer_video(T=4)
    f = _perturbed(truth, seed=3)
    kw = dict(diameter=7, separation=6.0, param_mode={"size": "global"},
              param_val={"size": 2.2}, frames_per_dispatch=4)
    mesh = make_mesh(["cuda:0"] * 4)
    out = ctt.refine_leastsq(f, reader, mesh=mesh, **kw)
    pd.testing.assert_frame_equal(out, ctt.refine_leastsq(f, reader,
                                                          mesh=mesh, **kw))
    sizes = out.loc[out["cost"].notna(), "size"].to_numpy()
    assert sizes.size and np.ptp(sizes) < 1e-5
    one = ctt.refine_leastsq(f, reader, device="cuda", **kw)
    np.testing.assert_allclose(sizes.mean(), one.loc[one["cost"].notna(),
                                                     "size"].mean(),
                               rtol=1e-4)
