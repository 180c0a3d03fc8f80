"""The trace reading and the readers that sum its idle gaps, on synthetic
runs."""
from types import SimpleNamespace

from torch.autograd import DeviceType

import core

T = 100_000   # ns a host range


class Event:
    """The part of a profiler event that ``core.read_trace`` reads."""

    def __init__(self, name, start, dur, on_device):
        self._name, self._start, self._dur = name, start, dur
        self._dev = DeviceType.CUDA if on_device else DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._dev == DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def profile(labels):
    """A window of one host range a label, each busy on the device from its
    start and idle for the last (i + 1) us of it."""
    events = [Event("portbench.window", 0, len(labels) * T, False)]
    for i, label in enumerate(labels):
        events.append(Event(label, i * T, T, False))
        events.append(Event(f"kernel_{i}", i * T, T - (i + 1) * 1000, True))
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=results))


def test_read_trace_keeps_every_idle_label():
    labels = [f"stage.{i:02d}" for i in range(12)]
    tr = core.read_trace(profile(labels))
    assert [k for k, _ in tr["idle_gaps"]] == labels[::-1]
    for i, (_, s) in enumerate(reversed(tr["idle_gaps"])):
        assert abs(s - (i + 1) * 1e-6) < 1e-12
    assert len(tr["device_ops"]) == 10
    assert abs(tr["window_s"] - 12 * T / 1e9) < 1e-12
    assert abs(tr["busy_s"] + 78e-6 - 12 * T / 1e9) < 1e-12


def test_solver_host_gap_ms():
    reader = core.load_module("metrics", "solver.host_gap_ms")
    assert reader.UNIT == "ms"
    calls = [(0.0, 1.0, {"clusters": 1})] * 4
    run = core.Run(setup_s=1.0, calls=calls, window_s=4.0, records={})
    assert reader.read(run) is None
    labels = ["solver.round", "refine.drain", "solver.kernel",
              "portbench.solve", "solver.setup", "solver.finish"]
    run.trace = core.read_trace(profile(labels))
    # solver.* hold us 1, 3, 5 and 6 of idle: 15 us over 4 calls
    assert abs(reader.read(run) - 15e-3 / 4) < 1e-12
