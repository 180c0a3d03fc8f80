"""``refine_leastsq``'s DataFrame layer on arrays, held to the JAX package
(CPU).

``refine_leastsq`` reads the columns it needs once, finds, buckets,
assembles and writes back on numpy arrays, and builds its output table in
one construction.  What has to hold, against the reference's
``refine_leastsq`` (``lm_backend='xla'``) on the same inputs:

- the output's structure exactly: its columns and their order, every
  dtype, the index (non-default and non-monotonic ones included) and
  ``attrs``; the columns the fit does not set equal to the reference's,
  untouched string, object and categorical columns included;
- the fitted columns to tests/test_torch_refine.py's tolerances, float32
  on both sides with sums in another order;
- with both packages' bucket solvers stubbed, what each solver receives
  (``params0``, ``fvalid``, ``valid``, ``frame_idx``, the window shape)
  bit for bit, in the same dispatch order.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu as ct
import clustertracking_tpu.refine as jax_refine
import clustertracking_tpu_torch as ctt
from clustertracking_tpu.models.packing import build_layout as jax_layout
from clustertracking_tpu_torch import artificial, diagnostics
from clustertracking_tpu_torch import refine as port_refine
from clustertracking_tpu_torch.entry import example_batch
from clustertracking_tpu_torch.models.packing import build_layout

refine_cpu = functools.partial(ctt.refine_leastsq, device="cpu")

torch.set_num_threads(1)

POS_ATOL = 1e-4
RTOL = 1e-4
RMS_ATOL = 2.0 ** -23
FITTED = ("background", "signal", "y", "x", "size", "cost")


def _scene():
    """Three noisy 96×128 frames, each with a single, two dimers, a
    trimer and a 5-chain (which pads up the ladder into bucket 6), rows
    in a shuffled order."""
    rng = np.random.default_rng(7)
    frames = np.zeros((3, 96, 128))
    rows = []
    for t in range(3):
        for center, n, sep in [((20, 20), 1, 5.0), ((20, 60), 2, 5.0),
                               ((60, 30), 3, 4.5), ((60, 90), 5, 4.5),
                               ((20, 100), 2, 5.0)]:
            center = np.asarray(center, float)
            if n == 1:
                artificial.draw_feature(frames[t], center, 2.0, 150.0)
                true = center[None]
            else:
                true = artificial.draw_cluster(
                    frames[t], center, size=2.0, separation=sep, n=n,
                    signal=150.0, angle=rng.uniform(0, np.pi))
            for p in true + rng.uniform(-0.25, 0.25, true.shape):
                rows.append({"frame": t, "y": p[0], "x": p[1],
                             "signal": 150.0})
    frames += rng.normal(0.0, 1.0, frames.shape)
    f = pd.DataFrame(rows).iloc[rng.permutation(len(rows))]
    f = f.reset_index(drop=True)
    return f, frames, dict(diameter=9, separation=5.5,
                           param_val={"size": 2.0})


def _index(f, kw):
    f = f.copy()
    f.index = pd.Index(np.random.default_rng(3).permutation(len(f)) * 3
                       + 11)
    return f, kw


def _extra_columns(f, kw):
    f = f.copy()
    n = len(f)
    f.insert(0, "name", [f"p{i}" for i in range(n)])
    f["label"] = pd.array((["a", "b"] * n)[:n], dtype="string")
    f["tag"] = pd.Series([("row", i) for i in range(n)], dtype=object)
    f["kind"] = pd.Categorical((["u", "v", "w"] * n)[:n])
    f["count"] = np.arange(n, dtype=np.int32)
    f.attrs["source"] = {"camera": "A"}
    return f, kw


def _user_cluster(f, kw):
    f = ctt.find_clusters(f, kw["separation"])
    f["cluster"] = f["cluster"] * 7 + 100
    return f, kw


CASES = {
    "non_monotonic_index": _index,
    "extra_columns": _extra_columns,
    "frames_per_dispatch_2": lambda f, kw: (
        f, dict(kw, frames_per_dispatch=2)),
    "ladder_5_into_6": lambda f, kw: (f, kw),
    "spill_past_max_cluster_size": lambda f, kw: (
        f, dict(kw, max_cluster_size=4)),
    "user_cluster_column": _user_cluster,
    "compute_error": lambda f, kw: (f, dict(kw, compute_error=True)),
    "everything_at_once": lambda f, kw: _user_cluster(*_extra_columns(
        *_index(f, dict(kw, frames_per_dispatch=2, compute_error=True)))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_output_matches_reference(case):
    f, frames, kw = _scene()
    f, kw = CASES[case](f, kw)
    with diagnostics.collect() as stats:
        out = refine_cpu(f, frames, **kw)
    jout = ct.refine_leastsq(f, frames, lm_backend="xla", **kw)

    assert list(out.columns) == list(jout.columns)
    pd.testing.assert_index_equal(out.columns, jout.columns, exact=True)
    pd.testing.assert_index_equal(out.index, jout.index, exact=True)
    pd.testing.assert_series_equal(out.dtypes, jout.dtypes)
    assert out.attrs == jout.attrs == f.attrs
    # what the fit does not set: equal to the reference's and the input's
    untouched = [c for c in out.columns if c not in FITTED
                 and not c.endswith("_std") and c not in (
                     "fit_converged", "fit_n_iter")]
    pd.testing.assert_frame_equal(out[untouched], jout[untouched],
                                  check_exact=True)
    for c in f.columns:
        if c in untouched:
            pd.testing.assert_series_equal(out[c], f[c], check_exact=True)
    np.testing.assert_array_equal(out["fit_converged"],
                                  jout["fit_converged"])

    np.testing.assert_allclose(out[["y", "x", "size"]].to_numpy(),
                               jout[["y", "x", "size"]].to_numpy(),
                               atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out["signal"], jout["signal"], rtol=RTOL)
    np.testing.assert_allclose(out["background"], jout["background"],
                               rtol=0, atol=RTOL * 150.0)
    np.testing.assert_allclose(out["cost"], jout["cost"], rtol=RTOL,
                               atol=RMS_ATOL)
    assert out["cost"].notna().all()
    for c in [c for c in out.columns if c.endswith("_std")]:
        np.testing.assert_allclose(out[c], jout[c], rtol=1e-3)

    sizes = {b.cluster_size for b in stats.batches}
    backends = {b.backend for b in stats.batches}
    if "max_cluster_size" in kw:
        assert 5 in sizes and "scipy" in backends   # the 5-chain spilled
    else:
        assert 6 in sizes and "scipy" not in backends


def _stub_port(seen):
    def solver(model, ndim, isotropic, n, param_mode_key, wshape, *_):
        layout = build_layout(model, ndim, isotropic, n,
                              dict(param_mode_key))

        def solve(frames, fidx, params0, pose0, valid, fvalid=None):
            seen.append((n, wshape, fidx.numpy(), params0.numpy(),
                         valid.numpy(), fvalid.numpy()))
            B = params0.shape[0]
            return (params0, torch.zeros(B), torch.ones(B, dtype=torch.bool),
                    torch.zeros(B, dtype=torch.int32), torch.zeros(0))
        return solve, layout
    return solver


def _stub_jax(seen):
    def solver(model, ndim, isotropic, n, param_mode_key, wshape, *_):
        layout = jax_layout(model, ndim, isotropic, n, dict(param_mode_key))

        def solve(frames, fidx, params0, pose0, valid, fvalid=None):
            seen.append((n, wshape, np.asarray(fidx), np.asarray(params0),
                         np.asarray(valid), np.asarray(fvalid)))
            B = params0.shape[0]
            return (params0, jnp.zeros(B), jnp.ones(B, dtype=bool),
                    jnp.zeros(B, dtype=jnp.int32), jnp.zeros(0))
        return solve, layout
    return solver


@pytest.mark.parametrize("scene", ["dimer_grid", "mixed_sizes"])
def test_solver_receives_what_the_reference_sends(monkeypatch, scene):
    """Both packages' bucket solvers stubbed (the fit returns its start):
    every dispatch gets the same lanes, bit for bit."""
    if scene == "dimer_grid":
        # the dimer2d benchmark cell's frame: 256 dimers on 256²
        frames, _, params0, _, _ = example_batch(B=256, frame_size=256)
        start = params0.reshape(-1, 5).astype(float)
        f = pd.DataFrame({"frame": np.zeros(len(start), np.int64),
                          "y": start[:, 2], "x": start[:, 3],
                          "signal": start[:, 1]})
        kw = dict(diameter=9, separation=6.0, max_iter=10, max_shift=1.0,
                  lm_max_iter=60, max_rms_dev=1.0)
    else:
        f, frames, kw = _scene()
        f, kw = CASES["everything_at_once"](f, kw)
        kw.pop("compute_error")
    port_seen, jax_seen = [], []
    monkeypatch.setattr(port_refine, "_bucket_solver", _stub_port(port_seen))
    monkeypatch.setattr(jax_refine, "_bucket_solver", _stub_jax(jax_seen))
    out = refine_cpu(f, frames, **kw)
    jout = ct.refine_leastsq(f, frames, lm_backend="xla", **kw)
    assert len(port_seen) == len(jax_seen) >= 1
    for got, want in zip(port_seen, jax_seen):
        assert got[:2] == want[:2]                   # n, window shape
        for a, b in zip(got[2:], want[2:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    pd.testing.assert_frame_equal(out, jout, check_exact=True)


def test_duplicate_index_labels():
    """Rows are addressed by position, so an index with repeated labels
    (which the reference's label lookup cannot take: it raises) gives the
    rows of the same table under a default index, with the index kept."""
    f, frames, kw = _scene()
    dup = f.set_axis(pd.Index(np.arange(len(f)) // 2), axis=0)
    out = refine_cpu(dup, frames, **kw)
    pd.testing.assert_index_equal(out.index, dup.index, exact=True)
    pd.testing.assert_frame_equal(out.reset_index(drop=True),
                                  refine_cpu(f, frames, **kw),
                                  check_exact=True)
