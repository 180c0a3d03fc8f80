"""train_leastsq in the port, held to the JAX package on the same numpy
inputs: tests/test_train.py's four single-device cases run through both
packages (the port on the CPU), the learned values within 1e-3 of the
reference's, and each case's own ground-truth tolerance on the port.

Also what the port refuses: 'size' trained globally on data with per-axis
size columns (``ValueError`` before any fit; the reference's docstring
excludes it, and it refuses only by accident, deep in its first refit),
and ``mesh=`` (``NotImplementedError``).  The card test trains on CUDA.
"""
import functools

import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial, diagnostics

torch.set_num_threads(1)

# the port runs on CUDA unless asked for the CPU
train_cpu = functools.partial(ctt.train_leastsq, device="cpu")
refine_cpu = functools.partial(ctt.refine_leastsq, device="cpu")

LEARNED_ATOL = 1e-3
KW = dict(diameter=11, separation=6, fit_function="inv_series_2",
          param_mode={"size": "const"})


# tests/test_train.py's PSF, 1 / (1 + a1 r² + a2 r⁴), and its scene, drawn
# with the port's copy of artificial (numpy only, so the card test needs no
# JAX)
A1, A2 = 0.8, 0.25


def _psf(r2):
    return 1.0 / (1.0 + A1 * r2 + A2 * r2 * r2)


def _scene(mixed, n_spots=12, seed=3):
    rng = np.random.default_rng(seed)
    img = np.zeros((160, 160))
    rows = []
    grid = [(y, x) for y in range(25, 140, 28) for x in range(25, 140, 28)]
    rng.shuffle(grid)
    centers = iter(grid)
    k = 0
    while k < n_spots:
        n = 2 if (mixed and k % 3 == 0) else 1
        center = np.asarray(next(centers), float) + rng.uniform(-3, 3, 2)
        if n == 1:
            pos = np.atleast_2d(center + 0.0)
            artificial.draw_feature(img, pos[0], 2.0, 180.0, _psf,
                                    cutoff_sigmas=8.0)
        else:
            pos = artificial.draw_cluster(
                img, center, size=2.0, separation=5.0, n=2, signal=180.0,
                angle=rng.uniform(0, np.pi), feat_func=_psf,
                cutoff_sigmas=8.0)
        for p in pos:
            rows.append({"frame": 0, "y": p[0], "x": p[1], "signal": 180.0,
                         "size": 2.0})
            k += 1
    return img, pd.DataFrame(rows)


def _truth():
    return A1, A2


@pytest.mark.parametrize("mixed", [False, True])
def test_scene_is_the_reference_scene(mixed):
    """The scene above is tests/test_train.py's, pixel for pixel."""
    from test_train import _scene as reference_scene

    img, f = _scene(mixed)
    img_j, f_j = reference_scene(mixed=mixed)
    np.testing.assert_array_equal(img, img_j)
    pd.testing.assert_frame_equal(f, f_j)


def _agree(learned, learned_j):
    assert sorted(learned) == sorted(learned_j) == ["coeff_1", "coeff_2"]
    for k in learned:
        assert abs(learned[k] - learned_j[k]) < LEARNED_ATOL, (
            k, learned[k], learned_j[k])


@pytest.mark.parametrize("mixed,tol", [(False, 0.05), (True, 0.07)])
def test_train_recovers_coefficients_as_jax(mixed, tol):
    """test_train_inv_series_recovers_coefficients (singles) and
    test_train_mixed_cluster_sizes (singles and dimers): the dispatches of
    the refit rounds are tagged cpu-torch-global."""
    import clustertracking_tpu as ct

    img, f = _scene(mixed)
    learned_j = ct.train_leastsq(f, img, **KW)
    with diagnostics.collect() as stats:
        learned = train_cpu(f, img, **KW)
    _agree(learned, learned_j)
    assert {b.backend for b in stats.batches} == {"cpu-torch-global"}
    a1, a2 = _truth()
    assert abs(learned["coeff_1"] - a1) < tol
    assert abs(learned["coeff_2"] - a2) < tol


def test_train_feeds_back_into_refine_as_jax():
    """test_train_feeds_back_into_refine: the learned coefficients as
    param_val make refine_leastsq recover positions to 0.03 px, in both
    packages, with positions within 1e-3 px of each other."""
    import clustertracking_tpu as ct

    img, f = _scene(False)
    learned_j = ct.train_leastsq(f, img, **KW)
    learned = train_cpu(f, img, **KW)
    _agree(learned, learned_j)
    f0 = f.copy()
    f0["y"] += 0.3
    f0["x"] -= 0.2
    out = refine_cpu(f0, img, param_val=learned, **KW)
    out_j = ct.refine_leastsq(f0, img, param_val=learned_j, **KW)
    np.testing.assert_allclose(out[["y", "x"]].to_numpy(),
                               out_j[["y", "x"]].to_numpy(), atol=1e-3)
    err = np.hypot(out["y"] - f["y"], out["x"] - f["x"])
    assert float(err.max()) < 0.03


def test_train_joint_beats_mean_pooling_as_jax():
    """test_train_joint_beats_mean_pooling: dim mis-sized singles and
    bright dimers; the pooled normal equations recover the truth, where
    a count-weighted mean of the per-bucket estimates is biased."""
    import clustertracking_tpu as ct

    rng = np.random.default_rng(7)
    img = np.zeros((200, 200))
    rows = []
    grid = [(y, x) for y in range(20, 190, 24) for x in range(20, 190, 24)]
    rng.shuffle(grid)
    it = iter(grid)
    for _ in range(20):
        c = np.asarray(next(it), float) + rng.uniform(-3, 3, 2)
        artificial.draw_feature(img, c, 2.0, 18.0, _psf, cutoff_sigmas=8.0)
        rows.append({"frame": 0, "y": c[0], "x": c[1], "signal": 18.0,
                     "size": 2.4})
    for _ in range(4):
        c = np.asarray(next(it), float)
        pos = artificial.draw_cluster(
            img, c, size=2.0, separation=5.0, n=2, signal=220.0,
            angle=rng.uniform(0, np.pi), feat_func=_psf, cutoff_sigmas=8.0)
        for p in pos:
            rows.append({"frame": 0, "y": p[0], "x": p[1], "signal": 220.0,
                         "size": 2.0})
    img = img + rng.normal(0, 2.0, img.shape)
    f = pd.DataFrame(rows)
    a1, a2 = _truth()

    joint = train_cpu(f, img, **KW)
    _agree(joint, ct.train_leastsq(f, img, **KW))
    assert abs(joint["coeff_1"] - a1) < 0.03
    assert abs(joint["coeff_2"] - a2) < 0.03

    f_cl = ctt.find_clusters(f, 6)
    fs = f_cl[f_cl.cluster_size == 1]
    fd = f_cl[f_cl.cluster_size == 2]
    es, ed = train_cpu(fs, img, **KW), train_cpu(fd, img, **KW)
    _agree(es, ct.train_leastsq(fs, img, **KW))
    _agree(ed, ct.train_leastsq(fd, img, **KW))
    ns, nd = len(fs), len(fd)
    pooled = {k: (ns * es[k] + nd * ed[k]) / (ns + nd) for k in es}
    assert abs(pooled["coeff_1"] - a1) > 0.1
    assert abs(pooled["coeff_2"] - a2) > 0.1


class _Unreadable:
    """A reader whose frames cannot be read: shows how far a call gets."""

    def __getitem__(self, t):
        raise LookupError("frame read")

    def __len__(self):
        return 1


def _aniso_features():
    f = pd.DataFrame({"frame": [0, 0], "y": [20.0, 60.0], "x": [30.0, 50.0],
                      "signal": [100.0, 100.0], "size_y": [2.0, 2.0],
                      "size_x": [2.0, 2.0]})
    return f


def test_train_refuses_global_anisotropic_size():
    """The port raises ValueError for 'size' trained globally on per-axis
    sizes before it reads a frame; the reference, which excludes it only
    in its docstring (clustertracking_tpu/train.py:152-155), goes on to
    its first refit (here: the frame read fails) and stays as it is."""
    import clustertracking_tpu as ct

    f = _aniso_features()
    with pytest.raises(ValueError, match="per-axis size"):
        train_cpu(f, _Unreadable(), param_mode={"size": "global"},
                  **{k: v for k, v in KW.items() if k != "param_mode"})
    with pytest.raises(LookupError, match="frame read"):
        ct.train_leastsq(f, _Unreadable(), param_mode={"size": "global"},
                         **{k: v for k, v in KW.items()
                            if k != "param_mode"})
    # per-axis sizes by name: both refuse them as per-feature quantities
    for train in (train_cpu, ct.train_leastsq):
        with pytest.raises(ValueError, match="cannot train"):
            train(f, _Unreadable(), param_mode={"size_y": "global"},
                  **{k: v for k, v in KW.items() if k != "param_mode"})


def test_train_refuses_mesh():
    img, f = _scene(False)
    with pytest.raises(NotImplementedError, match="item 13"):
        train_cpu(f, img, mesh=object(), **KW)


def test_train_without_global_parameters_returns_empty():
    """Nothing in 'global' mode: nothing to learn, and no fit is run."""
    f = _aniso_features()
    assert train_cpu(f, _Unreadable(), diameter=11, fit_function="gauss") \
        == {}


@pytest.mark.cuda
def test_train_on_the_card_matches_cpu():
    """train_leastsq on CUDA (lm_solve_global and the pooled normal
    equations on the card; full float32, no TF32) against the same call
    on the CPU, on tests/test_train.py's mixed scene."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img, f = _scene(True)
    on_card = ctt.train_leastsq(f, img, device="cuda", **KW)
    on_cpu = train_cpu(f, img, **KW)
    for k in on_cpu:
        assert abs(on_card[k] - on_cpu[k]) < LEARNED_ATOL, (k, on_card,
                                                            on_cpu)
    a1, a2 = _truth()
    assert abs(on_card["coeff_1"] - a1) < 0.07
    assert abs(on_card["coeff_2"] - a2) < 0.07
