"""Port parity: the bucket solver and refine_leastsq, torch vs JAX (CPU).

The same numpy inputs go through ``clustertracking_tpu`` (its XLA solver,
``lm_backend='xla'``) and ``clustertracking_tpu_torch``.  Tolerances,
float32 on both sides with sums in another order:

- positions and sizes: atol 1e-4 px;
- signal: rtol 1e-4; background: 1e-4 of the signal scale;
- rms (``cost``): rtol 1e-4 plus atol 2**-23 — one float32 ulp of the
  normalized pixel scale, the resolution of a residual.  A noiseless fit
  ends at rms ~1.5e-7, which is rounding noise on either side;
- converged: equal on every lane;
- n_iter: equal before convergence.  At convergence the plateau exit
  counts trials whose cost differs from the current one by a few ulps, so
  the two frameworks' rounding moves it by a few iterations; those counts
  are logged in ROADMAP queue 3, not compared here.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu as ct
from __graft_entry__ import _example_batch
from clustertracking_tpu import artificial
from clustertracking_tpu.models.registry import get_model as jax_get_model
from clustertracking_tpu.refine import _bucket_solver as jax_bucket_solver
import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import diagnostics
from clustertracking_tpu_torch.entry import (
    MODES_3D, RADIUS_3D, WINDOW_3D, example_batch, example_batch_3d)
from clustertracking_tpu_torch.models import get_model
from clustertracking_tpu_torch.refine import _bucket_solver

# the port's refine_leastsq runs on CUDA unless asked for the CPU
refine_cpu = functools.partial(ctt.refine_leastsq, device="cpu")

torch.set_num_threads(1)

POS_ATOL = 1e-4
RTOL = 1e-4
RMS_ATOL = 2.0 ** -23


@pytest.mark.parametrize("kw", [
    dict(B=8, frame_size=64),
    dict(B=40, frame_size=64, seed=3),
    dict(B=20, frame_size=96, grid_pitch=24, T=3),
])
def test_example_batch_is_the_reference_batch(kw):
    for a, b in zip(example_batch(**kw), _example_batch(**kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _solvers(lm_backend, max_iter, lm_max_iter):
    args = (2, True, 2, (), (13, 13), (4.5, 4.5), (), None, 1e5, max_iter,
            1.0, lm_max_iter, 1.49e-8, 1.49e-8, False)
    solve, _ = _bucket_solver(get_model("gauss"), *args, lm_backend)
    jsolve, _ = jax_bucket_solver(jax_get_model("gauss"), *args, "xla")
    return solve, jsolve


def _assert_bucket_close(out, jout, iters_equal, pos=slice(2, 4)):
    params, rms, conv, iters, _ = out
    jparams, jrms, jconv, jiters, _ = (np.asarray(a) for a in jout)
    params = params.numpy()
    np.testing.assert_allclose(params[..., pos], jparams[..., pos],
                               atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(params[..., 1], jparams[..., 1], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(rms.numpy(), jrms, rtol=RTOL, atol=RMS_ATOL)
    np.testing.assert_array_equal(conv.numpy(), jconv)
    if iters_equal:
        np.testing.assert_array_equal(iters.numpy(), jiters)


@pytest.mark.parametrize("lm_backend", ["auto", "kernel"])
@pytest.mark.parametrize("max_iter,lm_max_iter,iters_equal", [
    (1, 2, True),       # before convergence: every count must agree
    (10, 60, False),    # the entry() configuration, run to convergence
])
def test_bucket_solver_matches_jax(lm_backend, max_iter, lm_max_iter,
                                   iters_equal):
    """_example_batch(B=8, frame_size=64), 13×13 windows: the port's
    bucket solver ('auto' = lm_solve on the CPU; 'kernel' = the fused
    route's plain version) against the JAX XLA solver."""
    solve, jsolve = _solvers(lm_backend, max_iter, lm_max_iter)
    arrays = _example_batch(B=8, frame_size=64)
    out = solve(*[torch.as_tensor(a) for a in arrays])
    jout = jsolve(*[jnp.asarray(a) for a in arrays])
    _assert_bucket_close(out, jout, iters_equal)


@pytest.mark.parametrize("max_iter,lm_max_iter,iters_equal", [
    (1, 2, True),
    (10, 60, False),    # config 4's schedule, run to convergence
])
def test_bucket_solver_3d_matches_jax_pallas(max_iter, lm_max_iter,
                                             iters_equal):
    """Config 4's bucket (anisotropic 3D dimers, 9×13×13 windows, V = 14)
    at B=8 on 32×48×48 stacks with noise (sigma 1): the port's gathered
    route ('kernel' = window_gather and pixel_lm's plain versions on the
    CPU) against the JAX solver's Pallas route in interpret mode."""
    frames, fidx, params0, pose0, valid = example_batch_3d(
        B=8, shape=(32, 48, 48))
    frames = frames + np.random.default_rng(3).normal(
        0.0, 1.0, frames.shape).astype(np.float32)
    arrays = (frames, fidx, params0, pose0, valid)
    args = (3, False, 2, MODES_3D, WINDOW_3D, RADIUS_3D, (), None, 1e5,
            max_iter, 1.0, lm_max_iter, 1.49e-8, 1.49e-8, False)
    solve, _ = _bucket_solver(get_model("gauss"), *args, "kernel")
    jsolve, _ = jax_bucket_solver(jax_get_model("gauss"), *args, "pallas")
    out = solve(*[torch.as_tensor(a) for a in arrays])
    jout = jsolve(*[jnp.asarray(a) for a in arrays])
    params, jparams = out[0].numpy(), np.asarray(jout[0])
    np.testing.assert_allclose(params[..., 5:8], jparams[..., 5:8],
                               atol=POS_ATOL, rtol=0)  # sizes
    _assert_bucket_close(out, jout, iters_equal, pos=slice(2, 5))


def test_refine_leastsq_3d_multichunk_matches_jax_pallas():
    """tests/test_pallas_lm.py::test_pallas_3d_multichunk_ctab_matches_xla's
    z-stack dimers: the port's kernel route (plain versions on the CPU)
    against the reference's Pallas route, to that test's 2e-3 px."""
    rng = np.random.default_rng(6)
    img = np.zeros((32, 48, 48))
    rows = []
    for c in [(14.0, 14.0, 14.0), (16.0, 34.0, 30.0)]:
        true = artificial.draw_cluster(
            img, np.asarray(c), size=(1.5, 2.2, 2.2), separation=4.5, n=2,
            signal=150.0, angle=rng.uniform(0, np.pi))
        for p in true + rng.uniform(-0.2, 0.2, true.shape):
            rows.append({"frame": 0, "z": p[0], "y": p[1], "x": p[2],
                         "signal": 150.0})
    f = pd.DataFrame(rows)
    f["size_z"], f["size_y"], f["size_x"] = 1.4, 2.1, 2.1
    kw = dict(diameter=(7, 9, 9), separation=5.0, param_mode={
        "size_z": "var", "size_y": "var", "size_x": "var"})
    with diagnostics.collect() as stats:
        out = refine_cpu(f, img, lm_backend="kernel", **kw)
    jout = ct.refine_leastsq(f, img, lm_backend="pallas", **kw)
    assert {b.backend for b in stats.batches} == {"cpu-gathered"}
    assert out["cost"].notna().all()
    cols = ["z", "y", "x", "signal", "size_z", "size_y"]
    np.testing.assert_allclose(out[cols].to_numpy(), jout[cols].to_numpy(),
                               rtol=0, atol=2e-3)
    centers = np.array([[14.0, 14.0, 14.0], [16.0, 34.0, 30.0]])
    err = np.abs(out[["z", "y", "x"]].to_numpy().reshape(2, 2, 3)
                 .mean(axis=1) - centers).max()
    assert err < 0.05


def test_entry_runs_the_main_path_on_cpu():
    solve, args = ctt.entry("cpu", B=8, frame_size=64)
    params, rms, conv, iters, std = solve(*args)
    assert params.shape == (8, 2, 5) and std.numel() == 0
    assert torch.isfinite(rms).all() and rms.mean() < 0.1
    truth = example_batch(B=8, frame_size=64, with_truth=True)[5]
    err = np.abs(params[..., 2:4].numpy() - truth).max(axis=-1)
    assert np.median(err) < 0.05


def _compare_frames(out, jout, signal_scale):
    cols = [c for c in ("z", "y", "x", "size", "size_z", "size_y",
                        "size_x") if c in jout]
    np.testing.assert_allclose(out[cols].to_numpy(), jout[cols].to_numpy(),
                               atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out["signal"].to_numpy(),
                               jout["signal"].to_numpy(), rtol=RTOL, atol=0)
    np.testing.assert_allclose(out["background"].to_numpy(),
                               jout["background"].to_numpy(), rtol=0,
                               atol=RTOL * signal_scale)
    np.testing.assert_allclose(out["cost"].to_numpy(),
                               jout["cost"].to_numpy(), rtol=RTOL,
                               atol=RMS_ATOL)  # NaN (rejected) must match
    np.testing.assert_array_equal(out["fit_converged"].to_numpy(),
                                  jout["fit_converged"].to_numpy())
    np.testing.assert_array_equal(out["cluster"].to_numpy(),
                                  jout["cluster"].to_numpy())
    np.testing.assert_array_equal(out["cluster_size"].to_numpy(),
                                  jout["cluster_size"].to_numpy())


def _dimer_scene():
    img = np.zeros((64, 64))
    true = artificial.draw_cluster(img, (32, 32), size=3.0, separation=5.0,
                                   n=2, signal=200.0, angle=0.7)
    rng = np.random.default_rng(1)
    f = pd.DataFrame(true + rng.uniform(-0.4, 0.4, true.shape),
                     columns=["y", "x"])
    f["frame"] = 0
    return f, img, dict(diameter=9, separation=5.5,
                        param_mode={"size": "cluster"},
                        param_val={"size": 2.7}), 200.0


def _single_scene():
    true = np.array([[24.3, 30.7]])
    img = np.zeros((64, 64))
    artificial.draw_feature(img, true[0], 3.0, 200.0)
    rng = np.random.default_rng(0)
    f = pd.DataFrame(true + rng.uniform(-0.4, 0.4, true.shape),
                     columns=["y", "x"])
    f["frame"] = 0
    return f, img, dict(diameter=19, param_mode={"size": "var"},
                        param_val={"size": 2.5}), 200.0


def _noisy_scene(max_rms_dev):
    img = np.zeros((64, 64))
    artificial.draw_feature(img, (20.3, 20.7), 3.0, signal=200.0)
    img += np.random.default_rng(0).normal(0, 10.0, img.shape)
    f = pd.DataFrame([[20.0, 21.0]], columns=["y", "x"])
    f["frame"] = 0
    f["signal"] = 200.0
    return f, img, dict(diameter=9, param_val={"size": 3.0},
                        max_rms_dev=max_rms_dev), 200.0


def _flags_scene(max_rms_dev):
    img = np.zeros((64, 64))
    true = artificial.draw_cluster(img, (32, 32), size=3.0, separation=6.0,
                                   n=2, signal=200.0)
    f = pd.DataFrame(true + 0.2, columns=["y", "x"])
    f["frame"] = 0
    f["signal"] = 200.0
    return f, img, dict(diameter=9, param_val={"size": 3.0},
                        max_rms_dev=max_rms_dev), 200.0


def _video_scene():
    """Three frames of two dimers plus one single feature, as a [T, H, W]
    stack (a 1-bucket and a ladder-2 bucket per chunk), with noise so that
    every fit's rms lies well above float32 resolution."""
    rng = np.random.default_rng(4)
    frames = np.zeros((3, 48, 64))
    rows = []
    for t in range(3):
        for c in [(14.0, 16.0), (32.0, 44.0)]:
            true = artificial.draw_cluster(
                frames[t], np.asarray(c), size=2.5, separation=5.0, n=2,
                signal=150.0, angle=rng.uniform(0, np.pi))
            for p in true + rng.uniform(-0.3, 0.3, true.shape):
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 150.0})
        p = np.array([36.0, 12.0]) + rng.uniform(-1, 1, 2)
        artificial.draw_feature(frames[t], p, 2.5, 150.0)
        rows.append({"frame": t, "y": p[0] + 0.2, "x": p[1] - 0.2,
                     "signal": 150.0})
    frames += rng.normal(0.0, 1.5, frames.shape)
    return pd.DataFrame(rows), frames, dict(
        diameter=9, separation=6.0, param_val={"size": 2.5},
        frames_per_dispatch=2), 150.0


def _aniso_3d_scene():
    """tests/test_refine.py::test_3d_anisotropic with noise (sigma 1)."""
    img = np.zeros((24, 32, 32))
    true = np.array([[12.3, 16.6, 15.4]])
    artificial.draw_feature(img, true[0], (1.5, 2.5, 2.5), signal=100.0)
    img += np.random.default_rng(2).normal(0, 1.0, img.shape)
    f = pd.DataFrame(true + 0.3, columns=["z", "y", "x"])
    f["frame"] = 0
    f["size_z"], f["size_y"], f["size_x"] = 1.3, 2.2, 2.2
    return f, img, dict(diameter=(5, 9, 9), param_mode={
        "size_z": "var", "size_y": "var", "size_x": "var"}), 100.0


SCENES = {
    "dimer": _dimer_scene,
    "single_feature": _single_scene,
    "max_rms_dev_rejects": lambda: _noisy_scene(0.005),
    "max_rms_dev_accepts": lambda: _noisy_scene(1.0),
    "failure_flags": lambda: _flags_scene(1.0),
    "failure_flags_rejected": lambda: _flags_scene(1e-12),
    "video_stack": _video_scene,
    "anisotropic_3d": _aniso_3d_scene,
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_refine_leastsq_matches_jax(scene):
    f, img, kw, signal = SCENES[scene]()
    out = refine_cpu(f, img, **kw)
    jout = ct.refine_leastsq(f, img, lm_backend="xla", **kw)
    _compare_frames(out, jout, signal)
    # the reference's own acceptance semantics hold on the port's output
    if scene.endswith("rejects") or scene.endswith("rejected"):
        assert out["cost"].isna().all()
        np.testing.assert_array_equal(out[["y", "x"]].to_numpy(),
                                      f[["y", "x"]].to_numpy())
        assert (out["fit_n_iter"] > 0).all()
    else:
        assert out["cost"].notna().all()


def test_refine_leastsq_spill_to_scipy_matches_jax():
    """A 5-chain above max_cluster_size takes the host scipy path in both
    packages (the same hostref code): identical output, errors included."""
    img = np.zeros((96, 160))
    rng = np.random.default_rng(12)
    true = []
    for k in range(5):
        p = np.array([48.0 + rng.uniform(-1, 1), 30.0 + k * 4.5])
        artificial.draw_feature(img, p, 2.0, 150.0)
        true.append(p)
    true = np.asarray(true)
    f = pd.DataFrame(true + rng.uniform(-0.25, 0.25, true.shape),
                     columns=["y", "x"])
    f["frame"] = 0
    f["signal"] = 150.0
    kw = dict(diameter=9, separation=5.5, param_val={"size": 2.0},
              max_cluster_size=4, compute_error=True)
    with diagnostics.collect() as stats:
        out = refine_cpu(f, img, **kw)
    jout = ct.refine_leastsq(f, img, lm_backend="xla", **kw)
    assert [b.backend for b in stats.batches] == ["scipy"]
    cols = ["y", "x", "signal", "size", "cost", "fit_converged",
            "fit_n_iter", "y_std", "x_std", "signal_std"]
    pd.testing.assert_frame_equal(out[cols], jout[cols])
    assert np.abs(out[["y", "x"]].to_numpy() - true).max() < 0.05


def test_refine_leastsq_error_columns_match_jax():
    """compute_error=True on the batched path: the Gauss–Newton standard
    errors agree with the reference's (a noisy dimer, so they are well
    above float32 noise)."""
    img = np.zeros((64, 64))
    true = artificial.draw_cluster(img, (32, 32), size=3.0, separation=6.0,
                                   n=2, signal=200.0)
    img += np.random.default_rng(5).normal(0, 2.0, img.shape)
    f = pd.DataFrame(true + 0.2, columns=["y", "x"])
    f["frame"] = 0
    kw = dict(diameter=11, separation=6.5, compute_error=True,
              param_val={"size": 3.0})
    out = refine_cpu(f, img, **kw)
    jout = ct.refine_leastsq(f, img, lm_backend="xla", **kw)
    _compare_frames(out, jout, 200.0)
    for c in ("y_std", "x_std", "signal_std"):
        np.testing.assert_allclose(out[c].to_numpy(), jout[c].to_numpy(),
                                   rtol=1e-3)
    assert out["size_std"].isna().all() and jout["size_std"].isna().all()


def test_refine_leastsq_records_dispatches():
    f, img, kw, _ = _video_scene()
    with diagnostics.collect() as stats:
        refine_cpu(f, img, **kw)
    summary = stats.summary()
    assert summary["n_clusters"] == 9
    assert {b.backend for b in stats.batches} == {"cpu-torch"}
    assert {b.cluster_size for b in stats.batches} == {1, 2}


def test_refine_leastsq_runs_on_cuda_unless_asked_for_the_cpu():
    """With no ``device`` the fit runs on CUDA and, where there is no CUDA
    device, raises instead of carrying on on the host; ``device="cpu"``
    runs there."""
    f, img, kw, _ = _video_scene()
    if torch.cuda.is_available():
        with diagnostics.collect() as stats:
            ctt.refine_leastsq(f, img, **kw)
        assert all(b.backend.startswith("cuda") for b in stats.batches)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ctt.refine_leastsq(f, img, **kw)
    with diagnostics.collect() as stats:
        out = ctt.refine_leastsq(f, img, device="cpu", **kw)
    assert {b.backend for b in stats.batches} == {"cpu-torch"}
    assert out["cost"].notna().all()


def test_spill_profile_of_a_custom_model_takes_numpy():
    """The scipy spill path evaluates a custom model's torch ``fun`` on
    numpy arrays."""
    from clustertracking_tpu_torch.refine import _host_profile

    model = get_model({"name": "lorentz", "fun": lambda r2: 1.0 / (1.0 + r2)})
    r2 = np.linspace(0.0, 9.0, 10)
    np.testing.assert_allclose(_host_profile(model)(r2), 1.0 / (1.0 + r2))
    assert _host_profile(get_model("gauss")) == "gauss"


@pytest.mark.parametrize("kw,match", [
    # mesh= was refused until multi-device fits were ported (ROADMAP queue
    # 1 item 13); the case keeps its id and now checks that a mesh which is
    # not the port's Mesh raises TypeError
    pytest.param(dict(mesh=object()), "Mesh", id="kw0-item 13"),
    # backend_find='device' was refused until the device label propagation
    # was ported (ROADMAP queue 1 item 6, later item 10); the case keeps its
    # id and now checks that it groups the rows as the host path does
    pytest.param(dict(backend_find="device"), None, id="kw1-item 6"),
])
def test_refine_leastsq_refuses_what_is_not_ported(kw, match):
    f, img, base, _ = _dimer_scene()
    base = dict(base)
    base.pop("param_mode")
    base.update(kw)
    if match is None:
        out = refine_cpu(f.drop(columns="cluster", errors="ignore"), img,
                         **base)
        host = refine_cpu(f.drop(columns="cluster", errors="ignore"), img,
                          **{**base, "backend_find": "host"})
        pd.testing.assert_frame_equal(out, host)
        return
    with pytest.raises(TypeError, match=match):
        refine_cpu(f, img, **base)


def test_nan_trap_names_the_offending_cluster():
    f, img, kw, _ = _flags_scene(1.0)
    img = img.copy()
    img[30:36, 28:38] = np.nan
    with diagnostics.debug_nans():
        with pytest.raises(FloatingPointError, match="first offender"):
            refine_cpu(f, img, **kw)
    out = refine_cpu(f, img, **kw)  # trap off: rejected silently
    assert out["cost"].isna().all()
