"""Observability: profiler ranges + per-batch fit statistics.

Counterpart of ``clustertracking_tpu/diagnostics.py``.  ``stage`` marks a
pipeline stage as a ``torch.profiler.record_function`` range (visible in a
``torch.profiler`` trace, nearly free without one); ``trace_to`` records
such a trace of a block into a directory; ``collect`` gathers one
``BatchRecord`` per solver dispatch of ``refine_leastsq`` and, from
``track``, the pipeline loss ledger (per-stage feature counts and stage
wall clocks).

Usage::

    import clustertracking_tpu_torch as ctt

    with ctt.diagnostics.collect() as stats:
        out = ctt.refine_leastsq(f, reader, diameter=9, device="cuda")
    print(stats.summary())          # dict: clusters, rejects, iters, rate
    print(stats.summary_by_backend())   # the same per backend tag

    # a torch.profiler trace (TensorBoard's PyTorch profiler, or
    # chrome://tracing / Perfetto for the JSON file):
    with ctt.diagnostics.trace_to("/tmp/trace"):
        ctt.refine_leastsq(...)

The non-finite trap (``debug_nans`` or env ``CT_TPU_DEBUG_NANS=1``) makes
``refine_leastsq`` raise ``FloatingPointError`` at the first dispatch
with a non-finite fit cost, instead of rejecting the lane silently.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from typing import List, Optional

logger = logging.getLogger("clustertracking_tpu_torch")

__all__ = ["BatchRecord", "StatsCollector", "collect", "stage",
           "trace_to", "debug_nans", "nan_debug_active", "record_batch",
           "record_ledger"]

_NAN_DEBUG_ENV = os.environ.get("CT_TPU_DEBUG_NANS", "") not in ("", "0")

_local = threading.local()


def nan_debug_active() -> bool:
    """True when the non-finite trap is armed (context or env var)."""
    return getattr(_local, "nan_debug", _NAN_DEBUG_ENV)


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Arm the non-finite trap on this thread for the enclosed block."""
    prev = getattr(_local, "nan_debug", None)
    _local.nan_debug = bool(enabled)
    try:
        yield
    finally:
        if prev is None:
            del _local.nan_debug
        else:
            _local.nan_debug = prev


@dataclasses.dataclass
class BatchRecord:
    """One solver dispatch (one bucket of clusters, one frame chunk)."""

    cluster_size: int
    n_clusters: int          # valid lanes
    n_lanes: int             # padded batch
    n_converged: int
    n_rejected: int          # rms > max_rms_dev (originals kept)
    mean_lm_iters: float
    max_lm_iters: int
    mean_rms: float
    wall_s: float            # dispatch + result copy wall-clock
    backend: str             # '<device>-fused' | '-gathered' | '-torch' | 'scipy'

    @property
    def clusters_per_sec(self) -> float:
        return self.n_clusters / self.wall_s if self.wall_s > 0 else 0.0


class StatsCollector:
    """Accumulates BatchRecords from refine_leastsq dispatches, plus the
    pipeline loss ledger (per-stage feature counts from track())."""

    def __init__(self):
        self.batches: List[BatchRecord] = []
        self.ledger: dict = {}

    def add(self, rec: BatchRecord) -> None:
        self.batches.append(rec)
        logger.debug(
            "fit batch: n=%d B=%d/%d conv=%d rej=%d iters=%.1f "
            "rms=%.4g %.1f clusters/s [%s]",
            rec.cluster_size, rec.n_clusters, rec.n_lanes,
            rec.n_converged, rec.n_rejected, rec.mean_lm_iters,
            rec.mean_rms, rec.clusters_per_sec, rec.backend,
        )

    def summary(self) -> dict:
        if not self.batches:
            return {"n_clusters": 0}
        n = sum(b.n_clusters for b in self.batches)
        wall = sum(b.wall_s for b in self.batches)
        return {
            "n_batches": len(self.batches),
            "n_clusters": n,
            "n_converged": sum(b.n_converged for b in self.batches),
            "n_rejected": sum(b.n_rejected for b in self.batches),
            "lane_occupancy": n / max(
                sum(b.n_lanes for b in self.batches), 1
            ),
            "mean_lm_iters": sum(
                b.mean_lm_iters * b.n_clusters for b in self.batches
            ) / max(n, 1),
            "wall_s": wall,
            "clusters_per_sec": n / wall if wall > 0 else 0.0,
        }

    def summary_by_backend(self) -> dict:
        """Per-backend-tag {n_clusters, wall_s, clusters_per_sec}: the
        kernel routes' rates apart from the plain solves and the serial
        scipy spill (tags ``cuda-fused``, ``cuda-gathered``, ``cuda-torch``
        with ``-rigid`` / ``-penalty`` / ``-global``, and ``-sharded`` for
        a dispatch split over a mesh, ``scipy``; ``cpu-`` on the host)."""
        out: dict = {}
        for b in self.batches:
            d = out.setdefault(b.backend, {"n_clusters": 0, "wall_s": 0.0})
            d["n_clusters"] += b.n_clusters
            d["wall_s"] += b.wall_s
        for d in out.values():
            d["clusters_per_sec"] = (
                d["n_clusters"] / d["wall_s"] if d["wall_s"] > 0 else 0.0
            )
        return out


def _active_collector() -> Optional[StatsCollector]:
    return getattr(_local, "collector", None)


@contextlib.contextmanager
def collect():
    """Context manager: collect per-batch fit statistics on this thread."""
    prev = _active_collector()
    _local.collector = StatsCollector()
    try:
        yield _local.collector
    finally:
        _local.collector = prev


def record_batch(**kwargs) -> None:
    """Internal: called by refine_leastsq after each solver dispatch."""
    c = _active_collector()
    rec = BatchRecord(**kwargs)
    if c is not None:
        c.add(rec)
    else:
        logger.debug("fit batch (uncollected): %s", rec)


def record_ledger(**counts) -> None:
    """Internal: accumulate pipeline loss-ledger counters (track()).

    Numbers are summed into the active collector's ``ledger``, so every
    feature lost between locate and the linked output is attributed to a
    stage; strings (the resolved link backend) overwrite."""
    c = _active_collector()
    if c is None:
        logger.debug("pipeline ledger (uncollected): %s", counts)
        return
    for k, v in counts.items():
        if isinstance(v, str):
            c.ledger[k] = v
        else:
            c.ledger[k] = c.ledger.get(k, 0) + v


@contextlib.contextmanager
def stage(name: str):
    """Profiler range around a pipeline stage."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed block (host ops,
    the ``stage`` ranges and, where CUDA is available, the device's
    kernels and copies) into ``log_dir``, as one
    ``<worker>.<time>.pt.trace.json`` file (TensorBoard's PyTorch
    profiler reads the directory; the file is Chrome trace JSON).  Yields
    the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) \
            as prof:
        yield prof
