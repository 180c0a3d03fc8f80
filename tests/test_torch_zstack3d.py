"""Config 4 (confocal z-stacks of anisotropic dimers) on the port's 3D
bucket solver, held to the benchmark's plain reference
``portbench/reference/aniso_fit.py``, which imports nothing of the port,
on the benchmark's own scene generator ``portbench/gen/zstack_grid.py``
(both loaded from their files).  Config 4's window, radius, fitted sizes
and schedule, at a small size: one 32x48x48 stack of 8 dimers, starts
perturbed by ±0.03 on every entry as the benchmark's pool is."""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from clustertracking_tpu_torch import artificial
from clustertracking_tpu_torch.entry import (
    MODES_3D, RADIUS_3D, WINDOW_3D, entry_3d, example_batch_3d)
from clustertracking_tpu_torch.models.packing import build_layout
from clustertracking_tpu_torch.models.registry import get_model
from clustertracking_tpu_torch.refine import kernel_route

BENCH = Path(__file__).resolve().parents[1] / "portbench"
SHAPE, PITCH = (32, 48, 48), (16, 24, 24)
SIZE = (1.5, 2.2, 2.2)
SCHEDULE = dict(max_iter=10, max_shift=1.0, lm_max_iter=60, ftol=1.49e-8,
                xtol=1.49e-8)
# The per-lane tolerances of the benchmark's cell (workloads/
# zstack3d.solve.json): 1e-3 voxel on every position and size, the one the
# port's kernels are held to against their plain versions; 1e-7 of the
# signal on the rms, absolute, since a noise-free window's rms is ~1e-7
# itself and the gaps that matter are set by the noise (2 counts, an rms
# of 0.013 of the signal), where float32 rounding moves rms by ~1e-9.
TOL_PX, TOL_SIZE, TOL_RMS = 1e-3, 1e-3, 1e-7


def _bench(name):
    """``portbench/<name>.py``, imported from the benchmark's directory as
    its harness imports it."""
    sys.path.insert(0, str(BENCH))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(BENCH))


@pytest.fixture(scope="module")
def aniso_fit():
    return _bench("reference.aniso_fit")


@pytest.fixture(scope="module")
def zstack_grid():
    return _bench("gen.zstack_grid")


def _scene(zstack_grid, noise, seed=11, perturb=0.03):
    gen = torch.Generator()
    gen.manual_seed(seed)
    stacks, sidx, params0, truth = zstack_grid.draw(
        1, SHAPE, PITCH, generator=gen, device="cpu", size=SIZE,
        noise=noise)
    if perturb:
        params0 = zstack_grid.perturbed(params0, 1, generator=gen,
                                        amount=perturb)[0]
    return stacks, sidx, params0, truth


def _reference(aniso_fit, stacks, sidx, params0, precision="float32"):
    return aniso_fit.fit(stacks, sidx, params0,
                         torch.ones(len(params0), dtype=torch.bool),
                         window=WINDOW_3D, radius=RADIUS_3D,
                         precision=precision, **SCHEDULE)


def _gaps(params, rms, ref):
    """Per lane: largest position gap, largest size gap, rms gap."""
    params, rms = np.asarray(params), np.asarray(rms)
    rp, rr = ref["params"].numpy(), ref["rms"].numpy()
    pos = np.abs(params[:, :, 2:5] - rp[:, :, 2:5]).max(axis=(1, 2))
    size = np.abs(params[:, :, 5:8] - rp[:, :, 5:8]).max(axis=(1, 2))
    return pos, size, np.abs(rms - rr)


@pytest.mark.parametrize("lm_backend", ["auto", "kernel"])
@pytest.mark.parametrize("noise", [0.0, 2.0])
def test_port_matches_the_reference(aniso_fit, zstack_grid, noise,
                                    lm_backend):
    """``entry_3d``'s solver on the CPU (``auto``: ``lm_solve``;
    ``kernel``: the gathered route's plain version, ``gather_stack`` then
    ``pixel_lm_reference``) gives every lane's positions and three sizes
    within the cell's tolerances of the reference, and its rms."""
    stacks, sidx, params0, _ = _scene(zstack_grid, noise)
    solve, _ = entry_3d("cpu", batch=example_batch_3d(B=1),
                        lm_backend=lm_backend)
    B = len(params0)
    out = solve(stacks, sidx, params0, torch.zeros((B, 0)),
                torch.ones(B, dtype=torch.bool))
    ref = _reference(aniso_fit, stacks, sidx, params0)
    pos, size, rms = _gaps(out[0], out[1], ref)
    assert pos.max() <= TOL_PX, pos
    assert size.max() <= TOL_SIZE, size
    assert rms.max() <= TOL_RMS, rms
    assert torch.isfinite(out[1]).all()


def test_reference_recovers_the_truth(aniso_fit, zstack_grid):
    """On noise-free stacks from starts ±0.25 voxel off, the reference
    ends at the drawn positions and sizes: within 1e-4 voxel, the
    float32 floor of stacks rendered at 150 counts (measured ~4e-6)."""
    stacks, sidx, params0, truth = _scene(zstack_grid, 0.0, perturb=0.0)
    ref = _reference(aniso_fit, stacks, sidx, params0)
    assert (ref["params"][:, :, 2:5] - truth).abs().max() < 1e-4
    sizes = torch.tensor(SIZE)
    assert (ref["params"][:, :, 5:8] - sizes).abs().max() < 1e-4
    assert bool(ref["converged"].all())
    assert float(ref["rms"].max()) < 1e-6


@pytest.mark.parametrize("precision", ["tf32", "bfloat16"])
def test_lower_precision_misses_a_tolerance(aniso_fit, zstack_grid,
                                            precision):
    """The reference with TF32 operands in its sums over voxels (or in
    bfloat16), on the noisy stacks, puts some lane outside the cell's
    tolerances of the float32 reference: the comparison would catch a
    program that sums below float32."""
    stacks, sidx, params0, _ = _scene(zstack_grid, 2.0)
    ref = _reference(aniso_fit, stacks, sidx, params0)
    low = _reference(aniso_fit, stacks, sidx, params0, precision)
    pos, size, rms = _gaps(low["params"], low["rms"], ref)
    off = (pos > TOL_PX) | (size > TOL_SIZE) | (rms > TOL_RMS)
    assert off.any(), (pos, size, rms)


def test_the_layout_takes_the_gathered_route():
    """Config 4's bucket (two features, signal, positions and the three
    sizes fitted: 14 slots) in a 9x13x13 window takes ``gathered``:
    ``window_gather``, then ``pixel_lm``."""
    layout = build_layout(get_model("gauss"), 3, False, 2, dict(MODES_3D))
    assert layout.n_slots == 14
    assert kernel_route(get_model("gauss"), layout, False, None,
                        WINDOW_3D) == "gathered"


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 11])
def test_generator_is_deterministic_in_its_seed(zstack_grid, seed):
    """The same seed draws the same stacks, starts and truth, bit for bit;
    the next seed draws others."""
    a = _scene(zstack_grid, 2.0, seed=seed)
    b = _scene(zstack_grid, 2.0, seed=seed)
    c = _scene(zstack_grid, 2.0, seed=seed + 1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[2], c[2])


def test_generator_draws_config4s_scene(zstack_grid):
    """The noise-free stacks are what ``artificial.draw_feature`` renders
    at the drawn positions (within 1e-3 counts of 150: float32 sums
    against float64 adds), each dimer 4.5 voxels long in the (y, x) plane
    of its own cell, its starts within ±0.25 voxel."""
    stacks, _, params0, truth = _scene(zstack_grid, 0.0, perturb=0.0)
    img = np.zeros(SHAPE)
    for pair in truth.double().numpy():
        for p in pair:
            artificial.draw_feature(img, p, SIZE, 150.0)
    assert np.abs(img - stacks[0].numpy()).max() < 1e-3
    sep = (truth[:, 0] - truth[:, 1]).norm(dim=-1)
    assert torch.allclose(sep, torch.full_like(sep, 4.5), atol=1e-5)
    assert torch.equal(truth[:, 0, 0], truth[:, 1, 0])
    assert (params0[:, :, 2:5] - truth).abs().max() <= 0.25
    assert torch.equal(params0[:, :, 5:8],
                       torch.tensor(SIZE).expand(len(truth), 2, 3))
