"""The port's numpy-only copies give output identical to the originals.

Importing any ``clustertracking_tpu`` submodule imports JAX, so the port
carries copies of the numpy/scipy modules it needs (utils, artificial,
hostref, the host find path; the host ``Linker`` and ``motion`` are held
in tests/test_torch_link.py and tests/test_torch_motion.py).  Each is held
to its original, bit for bit, and the port's import is checked to pull in
neither JAX nor pandas.
"""
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import clustertracking_tpu.artificial as ref_artificial
import clustertracking_tpu.find as ref_find
import clustertracking_tpu.hostref as ref_hostref
import clustertracking_tpu.utils as ref_utils
from clustertracking_tpu.models import build_layout as ref_build_layout
from clustertracking_tpu.models import get_model as ref_get_model
from clustertracking_tpu.ops.find import host_connected_components
import clustertracking_tpu_torch.artificial as artificial
import clustertracking_tpu_torch.find as find
import clustertracking_tpu_torch.hostref as hostref
import clustertracking_tpu_torch.utils as utils
from clustertracking_tpu_torch.interop import from_reference

torch.set_num_threads(1)


def test_import_needs_neither_jax_nor_pandas():
    code = ("import sys, clustertracking_tpu_torch; "
            "bad = [m for m in ('jax', 'pandas') if m in sys.modules]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("call", [
    lambda m: m.validate_tuple(3, 2),
    lambda m: m.validate_tuple((1, 2, 3), 3),
    lambda m: m.default_pos_columns(3),
    lambda m: m.default_size_columns(2, False),
    lambda m: m.default_size_columns(3, True),
    lambda m: m.guess_pos_columns(pd.DataFrame(columns=["z", "y", "x"])),
    lambda m: m.is_isotropic((2.0, 2.0, 3.0)),
])
def test_utils_copy(call):
    assert call(utils) == call(ref_utils)


def test_utils_copy_raises_alike():
    for m in (utils, ref_utils):
        with pytest.raises(ValueError):
            m.validate_tuple((1, 2), 3)
        with pytest.raises(m.ClusterError):
            m.guess_pos_columns(pd.DataFrame(columns=["a"]))


@pytest.mark.parametrize("feat", ["gauss", "ring", "hat", "disc"])
def test_artificial_draw_copy(feat):
    out = []
    for m in (artificial, ref_artificial):
        img = np.zeros((48, 40))
        pos = m.draw_cluster(img, (20.3, 19.6), size=2.2, separation=4.5,
                             n=3, signal=120.0, angle=0.4, feat_func=feat)
        m.draw_feature(img, (5.5, 33.2), (1.5, 2.5), 80.0, feat)
        out.append((img, pos))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_artificial_generators_copy():
    for call in (
        lambda m: m.draw_spots((32, 32), [[10.2, 11.7], [20.1, 5.3]], 2.0,
                               [50.0, 80.0], noise_level=2.0, bitdepth=12,
                               rng=3),
        lambda m: m.draw_array(9, (30, 30), 1.5)[0],
        lambda m: m.gen_random_locations((20, 30, 40), 7, margin=2, rng=1),
        lambda m: m.gen_nonoverlapping_locations((64, 64), 12, 6.0,
                                                 rng=2),
        lambda m: m.gen_cluster_locations((5.0, 6.0, 7.0), 4, 2.0, 3, 0.3),
        lambda m: m.crop_pad(np.arange(100.0).reshape(10, 10), (-2, 7),
                             (5, 5)),
    ):
        np.testing.assert_array_equal(call(artificial), call(ref_artificial))


def test_artificial_readers_copy():
    f = pd.DataFrame({"frame": [0, 0, 1], "y": [5.0, 12.5, 8.0],
                      "x": [6.0, 3.5, 9.0], "signal": [10.0, 20.0, 30.0]})
    r, rr = (m.CoordinateReader(f, (16, 16), 1.5, noise_level=0.5)
             for m in (artificial, ref_artificial))
    assert len(r) == len(rr) == 2
    for a, b in zip(r, rr):
        np.testing.assert_array_equal(a, b)
    sims = []
    for m in (artificial, ref_artificial):
        s = m.SimulatedImage((24, 24), 2.0, signal=50.0)
        s.draw_cluster((12.0, 12.0), 4.0, 2, angle=0.3)
        s.add_noise(1.0, seed=4)
        sims.append(s)
    np.testing.assert_array_equal(sims[0](), sims[1]())
    pd.testing.assert_frame_equal(sims[0].coords_df(), sims[1].coords_df())


@pytest.mark.parametrize("profile,n,modes", [
    ("gauss", 2, {}),
    ("gauss", 1, {"size": "var"}),
    ("ring", 1, {"thickness": "cluster"}),
])
def test_hostref_copy(profile, n, modes):
    img = np.zeros((48, 48))
    true = ref_artificial.draw_cluster(img, (24.0, 23.0), size=2.5,
                                       separation=4.0, n=n, signal=150.0,
                                       angle=0.5)
    img += np.random.default_rng(9).normal(0, 1.0, img.shape)
    lay = ref_build_layout(ref_get_model(profile), 2, True, n, modes)
    p0 = np.zeros((n, lay.n_params))
    p0[:, 1] = 150.0
    p0[:, 2:4] = true + 0.3
    p0[:, 4] = 2.5
    if profile == "ring":
        p0[:, 5] = 0.2
    outs = [m.fit_cluster_scipy(img, p0, lay.slot_idx, (14, 14), (4.5, 4.5),
                                True, profile=profile, norm=150.0,
                                full_output=True)
            for m in (hostref, ref_hostref)]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(a, b)
    assert outs[0][3]["converged"] == outs[1][3]["converged"]
    np.testing.assert_array_equal(outs[0][3]["std"], outs[1][3]["std"])


def test_host_connected_components_copy():
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 60, (300, 2))
    np.testing.assert_array_equal(
        find.host_connected_components(coords, (3.0, 3.0)),
        host_connected_components(coords, (3.0, 3.0)),
    )


@pytest.mark.parametrize("separation", [4.0, (3.0, 5.0)])
def test_find_clusters_matches_reference(separation):
    rng = np.random.default_rng(6)
    f = pd.DataFrame({
        "frame": np.repeat([0, 1, 2], 80),
        "y": rng.uniform(0, 50, 240),
        "x": rng.uniform(0, 50, 240),
    })
    out = find.find_clusters(f, separation)
    ref = ref_find.find_clusters(f, separation, backend="host")
    pd.testing.assert_frame_equal(out, ref)
    # the device label propagation, on the CPU, groups alike
    out = find.find_clusters(f, separation, backend="device", device="cpu")
    pd.testing.assert_frame_equal(out, ref)


def test_clusters_union_find_copy():
    pairs = [(0, 3), (3, 7), (5, 6), (9, 5)]
    a, b = find.Clusters(range(10)), ref_find.Clusters(range(10))
    a.add_pairs(pairs)
    b.add_pairs(pairs)
    assert a.cluster_id == b.cluster_id
    assert a.cluster_size == b.cluster_size
    assert len(a) == len(b)


def test_from_reference_carries_the_state():
    from __graft_entry__ import _example_batch

    frames, fidx, params0, pose0, valid = _example_batch(B=8)
    lay = ref_build_layout(ref_get_model("gauss"), 2, True, 2,
                           {"size": "cluster"})
    st = from_reference(frames, fidx, params0, pose0, valid,
                        np.ones((8, 2)), layout=lay, device="cpu")
    assert st.frames.dtype == torch.float32 and st.frame_idx.dtype == \
        torch.int32 and st.valid.dtype == torch.bool
    np.testing.assert_array_equal(st.params0.numpy(), params0)
    np.testing.assert_array_equal(st.slot_idx.numpy(), lay.slot_idx)
    assert st.mode_masks["cluster"].tolist() == [
        m == "cluster" for m in lay.modes
    ]
    assert st.fvalid.dtype == torch.float32
