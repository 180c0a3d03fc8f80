"""Multi-device data parallelism: split the cluster batch over a Mesh.

Counterpart of ``clustertracking_tpu/parallel/sharding.py``.  The fit
stage is data parallel over clusters, so the batch (lane) axis splits
over the mesh's devices and the frames go whole to each device.  The
collectives, which GSPMD inserts in the reference, are the port's own
(``ops/collectives.py::all_reduce``): the shared-slot tie of
``lm_solve_global`` sums its per-shard partials in shard order — how 'global'-mode
parameters (``train_leastsq``, ``dimer_global``) fit across devices.

One process drives every shard, as the reference's single-controller
mesh does; a mesh may name one device several times (``["cuda:0"] * 4``,
``["cpu"] * 4``), the counterpart of its virtual CPU devices.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.registry import get_model
from ..ops.collectives import Mesh
from ..refine import _mesh_bucket_solver

__all__ = ["Mesh", "make_mesh", "sharded_fit", "fit_step_spec"]


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    """1D data-parallel mesh over every visible CUDA card (``devices=None``)
    or the given devices, which may repeat (``["cuda:0"] * 4``,
    ``["cpu"] * 4``).  With ``devices=None`` and no card, raises
    ``RuntimeError``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; name the devices "
                "(e.g. ['cpu'] * 4) to build a mesh on the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis,))


def fit_step_spec(mesh: Mesh, axis: str = "data"):
    """Placement of the bucket fit's (frames, frame_idx, params0, pose0,
    valid) over ``mesh``, in the reference's PartitionSpec terms: ``()``
    is whole on every device (the frames), ``(axis,)`` split by lane over
    the mesh's axis (the rest)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis_names}")
    lane, rep = (axis,), ()
    return (rep, lane, lane, lane, lane)


def sharded_fit(
    mesh: Mesh,
    fit_function,
    ndim: int,
    isotropic: bool,
    n: int,
    window_shape: tuple,
    radius: tuple,
    param_mode: Optional[dict] = None,
    axis: str = "data",
    **solver_kw,
):
    """Build a device-sharded bucket fit.

    Returns ``(fit, layout)``: ``fit(frames, frame_idx, params0, pose0,
    valid)`` (numpy arrays or tensors) splits the lanes into
    ``mesh.size`` contiguous blocks (the batch must divide evenly), runs
    ``refine._bucket_solver`` on each block's device and joins the
    outputs (params, rms, converged, iters, std) in lane order on the
    mesh's first device.

    ``solver_kw`` as ``_bucket_solver``'s, with the reference's defaults
    (``max_iter=10``, ``lm_max_iter=60``, ...).  The reference defaults
    ``lm_backend`` and ``gather_backend`` to 'xla' only because GSPMD
    cannot partition a ``pallas_call``; here both default to 'auto', so
    each shard takes the kernel route ``kernel_route`` picks on its
    device (the CUDA kernels on a card, their plain versions on the
    host), and buckets with tied slots all-reduce their ties across the
    shards.
    """
    fit_step_spec(mesh, axis)
    model = get_model(fit_function)
    kw = dict(
        param_mode_key=tuple(sorted((param_mode or {}).items())),
        bounds_key=(),
        constraint=None,
        residual_factor=1e5,
        max_iter=10,
        max_shift=1.0,
        lm_max_iter=60,
        ftol=1.49e-8,
        xtol=1.49e-8,
        compute_error=False,
        lm_backend="auto",
        gather_backend="auto",
        streaming=None,
    )
    unknown = set(solver_kw) - set(kw)
    if unknown:
        raise TypeError(f"sharded_fit: unknown solver arguments "
                        f"{sorted(unknown)}")
    kw.update(solver_kw)
    call, layout, _ = _mesh_bucket_solver(
        mesh, model, ndim, isotropic, n, kw["param_mode_key"],
        tuple(window_shape), tuple(radius), kw["bounds_key"],
        kw["constraint"], kw["residual_factor"], kw["max_iter"],
        kw["max_shift"], kw["lm_max_iter"], kw["ftol"], kw["xtol"],
        kw["compute_error"], kw["lm_backend"], kw["gather_backend"],
        kw["streaming"])

    def fit(frames, frame_idx, params0, pose0, valid):
        return call(frames, frame_idx, params0, pose0, valid)

    return fit, layout
