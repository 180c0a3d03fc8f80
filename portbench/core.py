"""The harness: one run of one cell of the port's benchmark.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``, the
parameters its driver's generator reads), its driver
(``drivers/<driver>.py``), the metrics it reports and the limits of its
comparison; each metric is a reader of its own
(``metrics/<metric>.py``).  The harness finds all of them by name, so a
later cell, configuration or metric is a set of new files.

A run: set-up (the driver makes its inputs from the seed, builds the
kernels its route loads and warms its own shapes), then a closed loop of
calls for ``seconds`` (``trace=1``: under ``torch.profiler``), closed by
a device synchronize; then the driver compares what the window produced
with the plain reference; then the metrics, one JSON line.

A driver module has ``make(cell, config, seed, device) -> driver``; the
driver has ``call(i) -> dict`` (one timed call; its counts), ``close()``
(after the window: free the program's state), ``check() -> list`` of
``Check`` (the comparison) and a ``records`` dict the readers may use;
for ``control.py`` also ``reference(keys, precision)``,
``program_fits()``, ``as_fits(ref)`` and ``gaps(fits, ref)``.  A cell's
tests (``tests/``) need two more names of its driver module:
``HOST_TRAFFIC``, the traffic entries that shrink its cells to a size the
host can hold, and ``plant(driver, fault)``, which wraps the driver's
program entry so that each call suffers ``fault`` (``"unchanged"``,
``"half"`` or ``"altered"``); so a cell with a new driver is new files,
its tests included.  A metric
module has ``UNIT`` and ``read(run) -> float | None`` (None: nothing to
read in this run, and the metric is left out).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run: the JAX package
# is the port's CPU reference, never the system under test
FORBIDDEN = ("jax", "jaxlib", "flax", "clustertracking_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct when ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)  # NaN is never ok


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    calls: list                 # (t_start, t_end, counts) of each call
    window_s: float             # first call's start to the synchronize
    records: dict               # the driver's
    trace: Optional[dict] = None


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, traffic: Optional[dict] = None):
    """(cell, config) of workload ``name``; ``cell["mix"]`` holds its
    traffic mix's parameters, with ``traffic``'s entries over them."""
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    cell["mix"] = {**load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
                   **(traffic or {})}
    return cell, config


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by path (metric
    names hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def window(driver, seconds: float, device, max_calls=None):
    """The closed loop: calls back to back until ``seconds`` have passed
    (or ``max_calls`` are done), then a device synchronize.  Returns
    (calls, window_s)."""
    import torch

    calls = []
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        counts = driver.call(i)
        te = time.perf_counter()
        calls.append((ts, te, counts))
        i += 1
        if te - t0 >= seconds or (max_calls and i >= max_calls):
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return calls, time.perf_counter() - t0


def _intervals_union(iv):
    """Merged, sorted [start, end] intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof, top: int = 10) -> dict:
    """Device time by operation name (``device_ops``: the ``top`` longest),
    busy seconds, and the idle gaps by the host range they fell in
    (``idle_gaps``: every range, longest first, so a reader can sum them
    by prefix), from the profiler's raw events (the device's own events
    only: a CPU op reports its kernels' time too, and ``record_function``
    ranges show on the device as spans that hold kernels;
    ``key_averages()`` costs ~80 us an event)."""
    from torch.autograd import DeviceType

    ops, dev_iv, host_ranges = {}, [], []
    win = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name == "Activity Buffer Request":
                continue
            d = e.duration_ns()
            ops[name] = ops.get(name, 0.0) + d / 1e9
            dev_iv.append((e.start_ns(), e.start_ns() + d))
        elif e.is_user_annotation():
            if name == "portbench.window":
                win = (e.start_ns(), e.start_ns() + e.duration_ns())
            else:
                host_ranges.append((e.start_ns(), e.duration_ns(), name))
    busy = _intervals_union(dev_iv)
    if win is None:
        win = (busy[0][0], busy[-1][1]) if busy else (0, 0)
    busy_ns = sum(max(0, min(e, win[1]) - max(s, win[0])) for s, e in busy)
    # idle gaps inside the window, each charged to the innermost host
    # range that holds its start
    gaps, prev = [], win[0]
    for s, e in busy:
        if s > prev:
            gaps.append((prev, min(s, win[1])))
        prev = max(prev, e)
    if prev < win[1]:
        gaps.append((prev, win[1]))
    # one sweep: ranges of one thread nest, so the innermost range open
    # at a gap's start is the top of a stack of open ranges
    host_ranges.sort(key=lambda r: (r[0], -r[1]))
    idle, stack, k = {}, [], 0
    for gs, ge in gaps:
        if ge <= gs:
            continue
        while k < len(host_ranges) and host_ranges[k][0] <= gs:
            hs, hd, hname = host_ranges[k]
            while stack and stack[-1][0] < hs:
                stack.pop()
            stack.append((hs + hd, hname))
            k += 1
        while stack and stack[-1][0] < gs:
            stack.pop()
        label = stack[-1][1] if stack else "outside the program's ranges"
        idle[label] = idle.get(label, 0.0) + (ge - gs) / 1e9
    by_time = sorted(ops.items(), key=lambda kv: -kv[1])
    return dict(ops=ops, busy_s=busy_ns / 1e9,
                window_s=(win[1] - win[0]) / 1e9,
                device_ops=[[k, v] for k, v in by_time[:top]],
                idle_gaps=[[k, v] for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])])


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device=None, t_start: Optional[float] = None,
            make_driver=None, traffic: Optional[dict] = None):
    """One run of ``workload``: set-up, window, check, metrics.

    Returns (result dict, checks).  ``device`` defaults to the first card;
    the tests pass ``"cpu"``, with ``traffic`` entries that shrink the
    cell to a size the host can hold.  ``make_driver`` replaces the
    driver's ``make`` (the tests plant faults through it)."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    cell, config = load_cell(workload, traffic)
    device = torch.device(device if device is not None else "cuda:0")
    mod = load_module("drivers", cell["driver"])
    make = make_driver or mod.make
    readers = {m: load_module("metrics", m)
               for m in cell["per_layer" if trace else "end_to_end"]}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    driver = make(cell, config, seed, device)
    setup_s = time.perf_counter() - t_start

    tracedata = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function("portbench.window"):
                calls, window_s = window(driver, seconds, device,
                                         cell.get("trace_calls"))
        tracedata = read_trace(prof)
        del prof
    else:
        calls, window_s = window(driver, seconds, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    driver.close()
    checks = driver.check()
    print(f"portbench: compared {json.dumps(driver.records.get('compare'))}",
          file=sys.stderr)
    run = Run(setup_s=setup_s, calls=calls, window_s=window_s,
              records=driver.records, trace=tracedata)
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks),
              "attempted": len(calls), "failed": 0,
              "metrics": metrics, "device": dev}
    if tracedata is not None:
        dev["busy_s"] = tracedata["busy_s"]
        dev["window_s"] = tracedata["window_s"]
        # the result line carries at most 10 entries a list
        result["breakdown"] = {"device_ops": tracedata["device_ops"],
                               "idle_gaps": tracedata["idle_gaps"][:10]}
    result["check"] = {c.name: {"value": c.value, "limit": c.limit}
                       for c in checks}
    return result, checks


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {torch.cuda.device_count()} cards, the cell "
              f"asks for {cell['chips']}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{_power_limit()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    result, checks = execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
