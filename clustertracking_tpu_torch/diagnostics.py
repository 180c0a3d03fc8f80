"""Observability: profiler ranges + per-batch fit statistics.

Counterpart of ``clustertracking_tpu/diagnostics.py``.  ``stage`` marks a
stage of the fit as a ``torch.profiler.record_function`` range while a
profiler runs, and costs one flag check when none does; ``trace_to``
records such a trace of a block into a directory; ``collect`` gathers one
``BatchRecord`` per solver dispatch of ``refine_leastsq`` and, from
``track``, the pipeline loss ledger (per-stage feature counts, stage
wall clocks and, after a device auction, its rounds and host syncs).

The ranges ``refine_leastsq`` opens (fixed names; sizes, indices and
routes go in the range's ``args``, never in its name; each range's parent
is the range that caused it, and the request's own range is the
caller's):

- ``refine.find``: cluster finding on the table's arrays
  (``find.cluster_ids``);
- ``refine.prepare``: the host work from the found table to a bucket's
  solver call: the write buffers, each chunk's frames read and stacked
  onto the device, the grouping into buckets, the integrity guard, the
  initial parameters, padding, the window shape, the solver lookup and
  the initial pose, and the uploads of the bucket's lane tensors (the
  scipy spill of clusters past ``max_cluster_size``, a host solve, runs
  in it too);
- ``refine.drain``: each bucket's fetch, non-finite trap, ``BatchRecord``
  and write-back, and the output table's one construction;
- ``solver.setup`` (``args`` n and B): every shard's solve state and the
  refit loop's state tensors;
- ``solver.round`` (``args`` the round's index): one refit round, from the
  check that any lane still needs it to the bookkeeping after its solve
  (shift, rms, the best-so-far updates); on the fused route on CUDA,
  whose rounds all run inside one ``fused_lm_2d`` launch, one range
  (round 0) around that launch;
- ``solver.kernel`` (``args`` the route taken, ``refit=device`` where
  the rounds run on the device, and, where the gathered route launches
  ``pixel_lm`` on CUDA, its mode, ``resident`` or ``streamed``, and its
  sums, ``f64_mma`` or ``fp32_regs``), inside ``solver.round``: the
  route's call for the round: window origins, the gather and the solve
  (``fused_lm_2d``, ``pixel_lm``, ``block_lm``, ``tied_lm``, ``lm_solve``
  or ``lm_solve_global_shards``);
- ``solver.gather`` (``args`` B and the window, ``9x13x13``), inside
  ``solver.kernel``: the round's window gather (``window_gather``, or
  ``gather_stack``), on every route but the fused one, which gathers
  nothing (``compute_error``'s gather stays in ``solver.finish``);
- ``solver.finish``: every shard's outputs (with ``compute_error``'s
  std), and the bucket's results packed for one copy to the host.

``track`` opens four ranges around its stages, once in a single-shot
run and once a chunk in a checkpointed one; ``refine.*`` and
``solver.*`` nest inside ``track.refine``:

- ``track.locate`` (``args`` frames): the candidates of the frames
  (``_locate_frames``: the frames read and stacked onto the device, the
  threshold statistics, the maxima, the sizes, the table);
- ``track.find`` (``args`` features): ``find_clusters`` on them;
- ``track.refine``: ``refine_leastsq`` and the recovery passes;
- ``track.link`` (``args`` the backend asked for and the features): the
  linking of the accepted rows (a device auction or the host
  ``Linker``).

The ``solver.*`` ranges come from the bucket solver itself, so a caller
of ``entry.entry``'s solver sees them too; on a mesh ``solver.setup``
holds the split of the lanes over the shards and ``solver.finish`` their
join.  In a trace that records the device, the device's idle time falls
under the range open when it began: a sync waits in the range that holds
it.

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

``refit_rounds()`` reads, on demand, the device counter of the refit
rounds past each cluster's first that ``fused_lm_2d`` ran inside its
launches (it waits for the device; no solve reads it).

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

import torch

logger = logging.getLogger("clustertracking_tpu_torch")

# true while a torch.profiler (or autograd profiler) records this process
_profiler_enabled = torch._C._autograd._profiler_enabled

__all__ = ["BatchRecord", "StatsCollector", "collect", "stage",
           "trace_to", "debug_nans", "nan_debug_active", "record_batch",
           "record_ledger", "refit_rounds"]

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
    # host wall-clock of the dispatch plus the wait for its result copy;
    # that wait overlaps the next chunk's work, so it is not the solver's
    wall_s: float
    backend: str             # '<device>-fused' | '-gathered' | '-torch' | 'scipy'
    # the solve alone: on CUDA the device time between events around the
    # solver call and its packing, on the host (and for the scipy spill)
    # the host clock around them
    solve_s: float = 0.0
    # {kernel: launches} of the dispatch, from the wrappers' counters
    launches: dict = dataclasses.field(default_factory=dict)

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
        launches: dict = {}
        for b in self.batches:
            for k, v in b.launches.items():
                launches[k] = launches.get(k, 0) + v
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
            "solve_s": sum(b.solve_s for b in self.batches),
            "launches": launches,
        }

    def summary_by_backend(self) -> dict:
        """Per-backend-tag {n_clusters, wall_s, clusters_per_sec}: the
        kernel routes' rates apart from the plain solves and the serial
        scipy spill (tags ``cuda-fused``, ``cuda-gathered``,
        ``cuda-block``, ``cuda-torch`` with ``-rigid`` / ``-penalty`` /
        ``-global``, and ``-sharded`` for a dispatch split over a mesh,
        ``scipy``; ``cpu-`` on the host)."""
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


def collecting() -> bool:
    """Internal: True while ``collect`` is active on this thread (the
    dispatches then time their solves and count their launches)."""
    return _active_collector() is not None


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


class stage:
    """``with stage(name, args):`` a profiler range around a stage of the
    fit, opened only while a profiler runs; otherwise the block runs with
    one flag check and no range.  ``name`` is fixed (see the module's
    list); ``args``, a dict of the numbers, becomes the range's argument
    string (``k=v`` pairs) only when the range opens."""

    __slots__ = ("name", "args", "_range")

    def __init__(self, name: str, args: Optional[dict] = None):
        self.name = name
        self.args = args
        self._range = None

    def __enter__(self):
        if _profiler_enabled():
            args = None if self.args is None else " ".join(
                f"{k}={v}" for k, v in self.args.items())
            self._range = torch.profiler.record_function(self.name, args)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def refit_rounds(device=None) -> int:
    """The refit rounds past each cluster's first that ``fused_lm_2d`` ran
    in its launches on ``device`` (every device: None) since the process
    started, from the kernel's device counter; waits for the device's
    queued work."""
    from .ops.fused_lm import fused_lm_2d

    return sum(int(t.item()) for d, t in fused_lm_2d.refits.items()
               if device is None or d == torch.device(device))


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

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) \
            as prof:
        yield prof
