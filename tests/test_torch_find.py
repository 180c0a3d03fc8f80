"""Cluster discovery in the port (``find.py``, ``ops/find.py``), held to
the JAX package on the same numpy inputs.

The scenes are tests/test_find.py's, plus pairs at exactly the
separation (the ``<=`` edge) on exactly representable coordinates.  What
has to agree, exactly:

- ``find_clusters`` with 'host' and with 'device' (the port's float64
  label propagation on the CPU) against the reference's same backend:
  the whole output DataFrame;
- the array core ``cluster_ids`` (what ``refine_leastsq`` calls) against
  the wrapper and the reference's columns, and its array union-find and
  ``_canonicalize`` against the reference's loops;
- the raw labels of ``connected_components`` against the reference's
  (root indices, the smallest index of each component: equal wherever
  both agree with the host), and the canonical labels against the host's
  union-find.

The card test holds the propagation on CUDA to the CPU and the host at
N = 16,384.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import find
from clustertracking_tpu_torch.find import (
    _canonicalize, host_connected_components)
from clustertracking_tpu_torch.ops.find import (
    cluster_sizes, connected_components)

torch.set_num_threads(1)


def _df(coords, frame=0, cols=("y", "x")):
    f = pd.DataFrame(np.asarray(coords, dtype=float), columns=list(cols))
    f["frame"] = frame
    return f


def _uniform(n, seed=1234):
    return _df(np.random.default_rng(seed).uniform(0, 60, (n, 2)))


# name -> (DataFrame, separation): tests/test_find.py's scenes
SCENES = {
    "pair_below_separation_merges": (_df([[10, 10], [10, 14]]), 5),
    "pair_above_separation_stays_split": (_df([[10, 10], [10, 16]]), 5),
    "distance_exactly_separation_merges": (_df([[10, 10], [10, 15]]), 5),
    "transitive_chain": (_df([[10, 10], [10, 14], [10, 18]]), 5),
    "per_frame_isolation": (pd.concat(
        [_df([[10, 10]], 0), _df([[10, 11]], 1)]).reset_index(drop=True),
        5),
    "anisotropic_merges": (_df([[10, 10], [14, 10]]), (5, 3)),
    "anisotropic_split": (_df([[10, 10], [10, 14]]), (5, 3)),
    "device_matches_host_5": (_uniform(5), 4),
    "device_matches_host_40": (_uniform(40), 4),
    "device_matches_host_300": (_uniform(300), 4),
    "device_long_chain": (_df(np.stack(
        [np.zeros(100), np.arange(100) * 3.0], axis=-1)), 3.5),
    "3d": (_df([[5, 10, 10], [7, 10, 10], [20, 10, 10]],
               cols=("z", "y", "x")), 3),
    # the <= edge on coordinates and separations that are exact in binary:
    # every distance below is exactly the separation
    "edge_fractional": (_df([[1.25, 0.0], [3.75, 0.0], [3.75, 2.5],
                             [9.0, 9.0]]), 2.5),
    "edge_anisotropic": (_df([[0.0, 0.0], [0.0, 3.0], [5.0, 3.0],
                              [5.0, 6.0]]), (5, 3)),
    "edge_3d": (_df([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [2.0, 0.0, 2.0]],
                    cols=("z", "y", "x")), 2),
}


def _ref_labels(coords, separation):
    """The reference's device labels (connected_components through its
    _labels_device: rows padded to 256, hi/lo split)."""
    from clustertracking_tpu.find import _labels_device

    return _labels_device(coords, separation)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_find_clusters_matches_reference(scene, backend):
    import clustertracking_tpu as ct

    f, sep = SCENES[scene]
    ref = ct.find_clusters(f, separation=sep, backend=backend)
    out = ctt.find_clusters(f, separation=sep, backend=backend, device="cpu")
    pd.testing.assert_frame_equal(out, ref)


@pytest.mark.parametrize("scene", list(SCENES))
def test_array_core_matches_wrapper_and_reference(scene):
    """``cluster_ids`` on the scene's arrays, what ``find_clusters`` wraps
    and ``refine_leastsq`` calls directly, gives the reference's
    ``cluster`` and ``cluster_size`` (its groupby over frames, its
    first-appearance ids) with either backend, and so does the wrapper;
    with no frame column, one frame."""
    import clustertracking_tpu as ct
    from clustertracking_tpu.utils import validate_tuple

    f, sep = SCENES[scene]
    cols = [c for c in ("z", "y", "x") if c in f.columns]
    coords = f[cols].to_numpy(dtype=float)
    ref = ct.find_clusters(f, separation=sep)
    for backend in ("host", "device"):
        cluster, sizes = find.cluster_ids(
            coords, f["frame"].to_numpy(), validate_tuple(sep, len(cols)),
            backend=backend, device="cpu")
        assert cluster.dtype == sizes.dtype == np.int64
        np.testing.assert_array_equal(cluster, ref["cluster"].to_numpy())
        np.testing.assert_array_equal(sizes, ref["cluster_size"].to_numpy())
    out = ctt.find_clusters(f, separation=sep)
    np.testing.assert_array_equal(out["cluster"].to_numpy(), cluster)
    np.testing.assert_array_equal(out["cluster_size"].to_numpy(), sizes)
    one = ct.find_clusters(f.drop(columns="frame"), separation=sep)
    cluster, sizes = find.cluster_ids(coords, None,
                                      validate_tuple(sep, len(cols)))
    np.testing.assert_array_equal(cluster, one["cluster"].to_numpy())
    np.testing.assert_array_equal(sizes, one["cluster_size"].to_numpy())


def test_frames_group_in_order_of_first_appearance():
    """Frames that come out of order, interleaved, and with a NaN frame:
    ids run over the frames in order of first appearance, as the
    reference's ``groupby(sort=False)`` has them, and rows of a NaN frame
    stay in no cluster (-1), counted together, as the reference leaves
    them."""
    import clustertracking_tpu as ct

    rng = np.random.default_rng(9)
    f = _df(rng.uniform(0, 20, (60, 2)))
    f["frame"] = rng.choice([3.0, 1.0, 7.0, np.nan], 60)
    out = ctt.find_clusters(f, 3.0)
    pd.testing.assert_frame_equal(out, ct.find_clusters(f, 3.0))
    assert (out["cluster"][f["frame"].isna()] == -1).all()


def test_canonical_ids_and_components_match_the_loops():
    """The array versions of ``_canonicalize`` (np.unique) and of the
    host union-find (hooks and pointer jumping) against loop versions:
    the reference's dict over labels, and its per-pair union-find (root
    = smallest index), on scenes with long chains, in 3D and with
    points in reverse order."""
    from clustertracking_tpu.find import _canonicalize as ref_canonicalize
    from clustertracking_tpu.ops.find import (
        host_connected_components as ref_components)

    rng = np.random.default_rng(11)
    scenes = [(rng.uniform(0, 60, (2000, 2))[::-1], 4.0),
              (np.stack([np.zeros(400), np.arange(400)[::-1] * 3.0], -1),
               3.5),
              (rng.uniform(0, 30, (500, 3)), (2.0, 2.5, 3.0)),
              (rng.uniform(0, 100, (3000, 2)), 1.5),
              (np.zeros((0, 2)), 1.0)]
    for coords, sep in scenes:
        labels = host_connected_components(coords, sep)
        np.testing.assert_array_equal(labels, ref_components(coords, sep))
        np.testing.assert_array_equal(_canonicalize(labels),
                                      ref_canonicalize(labels))
    shuffled = rng.permutation(np.repeat(rng.integers(0, 10**6, 300), 3))
    np.testing.assert_array_equal(_canonicalize(shuffled),
                                  ref_canonicalize(shuffled))


@pytest.mark.parametrize("scene", list(SCENES))
def test_raw_labels_match_reference(scene):
    from clustertracking_tpu.utils import validate_tuple

    f, sep = SCENES[scene]
    cols = [c for c in ("z", "y", "x") if c in f.columns]
    sep = validate_tuple(sep, len(cols))
    for _, g in f.groupby("frame"):
        coords = g[cols].to_numpy(dtype=float)
        raw = connected_components(
            torch.tensor(coords), torch.ones(len(coords), dtype=torch.bool),
            sep).numpy()
        np.testing.assert_array_equal(raw, _ref_labels(coords, sep))
        np.testing.assert_array_equal(
            _canonicalize(raw),
            _canonicalize(host_connected_components(coords, sep)))


def test_edges_merge():
    """Every pair at exactly the separation is a neighbour pair."""
    for scene, n_clusters in (("edge_fractional", 2),
                              ("edge_anisotropic", 1), ("edge_3d", 1)):
        f, sep = SCENES[scene]
        out = ctt.find_clusters(f, separation=sep, backend="device",
                                device="cpu")
        assert out["cluster"].nunique() == n_clusters, scene


def test_device_decides_exact_edges_the_host_rounds():
    """Integer candidates (what locate gives) 6 px apart at separation 6,
    from config 5's first frame: the host's float test works on
    coords / sep (188/6 and 194/6 lie 1.000000000000007 apart squared)
    and leaves the pair out, in both packages; the device paths of both
    subtract first and merge it, as "distance <= separation" says."""
    coords = np.array([[188.0, 565.0], [194.0, 565.0]])
    assert len(set(host_connected_components(coords, (6.0, 6.0)))) == 2
    raw = connected_components(torch.as_tensor(coords),
                               torch.ones(2, dtype=torch.bool), 6.0)
    np.testing.assert_array_equal(raw.numpy(), [0, 0])
    np.testing.assert_array_equal(_ref_labels(coords, (6.0, 6.0)), [0, 0])


def test_cluster_sizes_op():
    """tests/test_find.py::test_cluster_sizes_op: padding rows keep their
    own label and size 0; the propagation's blocks of 7 rows give the
    labels of one block."""
    coords = np.random.default_rng(1234).uniform(0, 30, (64, 2))
    valid = np.ones(64, dtype=bool)
    valid[50:] = False
    x, v = torch.as_tensor(coords), torch.as_tensor(valid)
    labels = connected_components(x, v, 4.0)
    np.testing.assert_array_equal(
        connected_components(x, v, 4.0, row_chunk=7).numpy(), labels.numpy())
    np.testing.assert_array_equal(labels[50:].numpy(), np.arange(50, 64))
    sizes = cluster_sizes(labels, v).numpy()
    ref = host_connected_components(coords[:50], 4.0)
    _, inv, counts = np.unique(ref, return_inverse=True, return_counts=True)
    np.testing.assert_array_equal(sizes[:50], counts[inv])
    assert (sizes[50:] == 0).all()
    assert connected_components.last_rounds >= 1


def test_auto_routes_large_frames_to_the_device(monkeypatch):
    """'auto' takes the device path for frames of at least
    _DEVICE_MIN_FEATURES candidates, on the resolved device: with no
    device named and no CUDA, such a frame raises rather than going to
    the host; smaller frames take the host and need no device."""
    f = pd.concat([_uniform(40), _df(np.random.default_rng(2).uniform(
        0, 60, (12, 2)), 1)]).reset_index(drop=True)
    calls = []
    orig = find._labels_device

    def spy(coords, separation, device):
        calls.append(len(coords))
        return orig(coords, separation, device)

    monkeypatch.setattr(find, "_labels_device", spy)
    monkeypatch.setattr(find, "_DEVICE_MIN_FEATURES", 20)
    out = ctt.find_clusters(f, 4, backend="auto", device="cpu")
    assert calls == [40]
    pd.testing.assert_frame_equal(out, ctt.find_clusters(f, 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ctt.find_clusters(f, 4, backend="auto")
        monkeypatch.setattr(find, "_DEVICE_MIN_FEATURES", 100)
        ctt.find_clusters(f, 4, backend="auto")
    with pytest.raises(ValueError):
        ctt.find_clusters(f, 4, backend="tpu")


@pytest.mark.cuda
def test_device_find_on_the_card_matches_host():
    """N = 16,384 uniform points at config 5's density (0.0095 per px²),
    separation 6: the card's raw labels equal the CPU's, and canonical
    labels the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 16384
    side = np.sqrt(n / 0.0095)
    coords = np.random.default_rng(5).uniform(0, side, (n, 2))
    valid = torch.ones(n, dtype=torch.bool)
    on_card = connected_components(torch.as_tensor(coords, device="cuda"),
                                   valid.cuda(), 6.0).cpu().numpy()
    on_cpu = connected_components(torch.as_tensor(coords), valid, 6.0)
    np.testing.assert_array_equal(on_card, on_cpu.numpy())
    np.testing.assert_array_equal(
        _canonicalize(on_card),
        _canonicalize(host_connected_components(coords, 6.0)))
