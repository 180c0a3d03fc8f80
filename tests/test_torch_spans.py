"""The port's profiler ranges (``diagnostics.stage``) and the per-dispatch
``BatchRecord`` fields beside them, on the CPU: ``refine_leastsq`` opens
the seven fixed names, and ``solver.gather`` inside ``solver.kernel`` on
every route that gathers windows, and no other, nested by cause, with
their numbers in ``args``; with no profiler running ``stage`` opens no
range at all; a dispatch records its solve time and its kernel
launches."""
import re
import time

import numpy as np
import pandas as pd
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import clustertracking_tpu_torch as ctt
from clustertracking_tpu_torch import artificial, diagnostics
from clustertracking_tpu_torch import refine as refine_mod
from clustertracking_tpu_torch.parallel.sharding import make_mesh

SPANS = {"refine.find", "refine.prepare", "refine.drain", "solver.setup",
         "solver.round", "solver.kernel", "solver.finish"}
# opened by every route but the fused one, which gathers no windows
GATHER = "solver.gather"

KW = dict(diameter=9, separation=6.0, device="cpu")


def _dimer_frame():
    """Three dimers and a single on a 96² frame, starts off by ~0.3 px."""
    img = np.zeros((96, 96))
    rows = []
    for center, n in [((25, 25), 2), ((25, 70), 2), ((70, 30), 2),
                      ((70, 70), 1)]:
        pos = artificial.draw_cluster(img, center, size=2.5, separation=5.0,
                                      n=n, signal=150.0, angle=0.5)
        for p in pos:
            rows.append({"frame": 0, "y": p[0] + 0.2, "x": p[1] - 0.2,
                         "signal": 150.0, "size": 2.5})
    return img, pd.DataFrame(rows)


def _ranges(prof):
    """[(name, start_ns, end_ns)] of the trace's user ranges."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _traced(**kw):
    img, f = _dimer_frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ctt.refine_leastsq(f, img, **{**KW, **kw})
    return out, _ranges(prof)


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _solve_3d(lm_backend, device="cpu"):
    """Config 4's bucket solver (``entry_3d``) on a 32x48x48 stack of 8
    dimers."""
    from clustertracking_tpu_torch.entry import entry_3d, example_batch_3d

    return entry_3d(device, lm_backend=lm_backend,
                    batch=example_batch_3d(B=8, shape=(32, 48, 48)))


def _recording(monkeypatch):
    """[(name, args)] of every range opened from here on, with the
    profiler's flag forced on."""
    opened = []
    real = torch.profiler.record_function

    def recording(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(diagnostics, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", recording)
    return opened


@pytest.mark.parametrize("lm_backend", ["torch", "kernel"])
def test_refine_opens_exactly_the_seven_spans(lm_backend):
    """Under a CPU profiler: the seven names, ``solver.gather`` where the
    route gathers windows ('torch': ``lm_solve`` on gathered windows) and
    not where it does not ('kernel' on 2D dimers: the fused route), and no
    other, none with a number; every ``solver.kernel`` inside a
    ``solver.round``, one ``solver.kernel`` a round that solved, one
    ``solver.gather`` inside each ``solver.kernel`` that gathers."""
    gathers = lm_backend == "torch"
    _, ranges = _traced(lm_backend=lm_backend)
    names = {r[0] for r in ranges}
    assert names == (SPANS | {GATHER} if gathers else SPANS)
    assert not any(ch.isdigit() for nm in names for ch in nm)
    rounds = [r for r in ranges if r[0] == "solver.round"]
    kernels = [r for r in ranges if r[0] == "solver.kernel"]
    assert kernels
    for k in kernels:
        assert sum(_inside(k, r) for r in rounds) == 1
    for r in rounds:
        assert sum(_inside(k, r) for k in kernels) <= 1
    for g in (r for r in ranges if r[0] == GATHER):
        assert sum(_inside(g, k) for k in kernels) == 1
    for k in kernels:
        assert sum(_inside(g, k) for g in ranges
                   if g[0] == GATHER) == int(gathers)


def test_spans_nest_by_cause():
    """The DataFrame API's ranges and the bucket solver's do not overlap
    one another: each solver range lies outside every ``refine.*`` range
    (a solver's parent is the caller's range), and ranges of one name
    never overlap."""
    _, ranges = _traced()
    refine_r = [r for r in ranges if r[0].startswith("refine.")]
    solver_r = [r for r in ranges if r[0] in ("solver.setup",
                                              "solver.round",
                                              "solver.finish")]
    for s in solver_r:
        for r in refine_r:
            assert s[2] <= r[1] or r[2] <= s[1], (s, r)
    for name in SPANS | {GATHER}:
        same = sorted(r[1:] for r in ranges if r[0] == name)
        for a, b in zip(same, same[1:]):
            assert a[1] <= b[0]


@pytest.mark.parametrize("lm_backend,route",
                         [("torch", "torch"), ("kernel", "fused")])
def test_span_args_carry_the_numbers(monkeypatch, lm_backend, route):
    """With a profiler on, each range opens through
    ``torch.profiler.record_function`` with its numbers in ``args``:
    the bucket's n and B, the round's index, the route taken, and a
    gather's B and window (the route 'torch' gathers; on the CPU no
    ``pixel_lm`` mode is named)."""
    opened = _recording(monkeypatch)
    img, f = _dimer_frame()
    ctt.refine_leastsq(f, img, lm_backend=lm_backend, **KW)
    by = {}
    for name, args in opened:
        by.setdefault(name, []).append(args)
    assert set(by) == (SPANS | {GATHER} if route == "torch" else SPANS)
    assert sorted(by["solver.setup"]) == ["n=1 B=32", "n=2 B=32"]
    assert "round=0" in by["solver.round"]
    assert set(by["solver.kernel"]) == {f"route={route}"}
    assert set(by["refine.prepare"]) == {None}
    for args in by.get(GATHER, []):
        assert re.fullmatch(r"B=32 window=\d+x\d+", args), args


@pytest.mark.parametrize("lm_backend,route",
                         [("kernel", "gathered"), ("torch", "torch")])
def test_gathering_routes_open_the_gather_span(monkeypatch, lm_backend,
                                               route):
    """A 3D bucket on the gathered route (its plain version on the CPU)
    and on the 'torch' route opens one ``solver.gather`` inside each
    ``solver.kernel``, with the lanes and the window in its ``args``."""
    solve, args = _solve_3d(lm_backend)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve(*args)
    ranges = _ranges(prof)
    kernels = [r for r in ranges if r[0] == "solver.kernel"]
    gathers = [r for r in ranges if r[0] == GATHER]
    assert kernels and len(gathers) == len(kernels)
    for k in kernels:
        assert sum(_inside(g, k) for g in gathers) == 1
    opened = _recording(monkeypatch)
    solve(*args)
    by = {}
    for name, a in opened:
        by.setdefault(name, set()).add(a)
    assert by[GATHER] == {"B=8 window=9x13x13"}
    assert by["solver.kernel"] == {f"route={route}"}


def test_stage_opens_no_range_without_a_profiler(monkeypatch):
    """No profiler running: ``stage`` never calls ``record_function``
    (made to raise here), and the fit runs through."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    with diagnostics.stage("solver.round", {"round": 0}):
        pass
    img, f = _dimer_frame()
    out = ctt.refine_leastsq(f, img, **KW)
    assert out["cost"].notna().all()


def test_stage_is_a_reusable_context_manager():
    """``stage`` is a class (no generator): an instance enters and leaves
    more than once, with and without a profiler, and an exception inside
    passes through with the range closed."""
    st = diagnostics.stage("solver.finish")
    for _ in range(2):
        with st:
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with st:
                pass
        with pytest.raises(ValueError):
            with diagnostics.stage("solver.kernel", {"route": "fused"}):
                raise ValueError("inside")
    names = [r[0] for r in _ranges(prof)]
    assert names.count("solver.finish") == 2
    assert names.count("solver.kernel") == 1


@pytest.mark.parametrize("lm_backend", ["torch", "kernel"])
def test_spans_leave_the_fit_unchanged(lm_backend):
    """The same fit, bit for bit, with the ranges open and without."""
    img, f = _dimer_frame()
    plain = ctt.refine_leastsq(f, img, lm_backend=lm_backend, **KW)
    traced, _ = _traced(lm_backend=lm_backend)
    pd.testing.assert_frame_equal(plain, traced)


def test_mesh_path_opens_the_same_spans():
    """Over a mesh of two CPU shards the same seven names and, the route
    being 'torch' on the CPU, ``solver.gather``; no other."""
    _, ranges = _traced(mesh=make_mesh(["cpu"] * 2))
    assert {r[0] for r in ranges} == SPANS | {GATHER}


def test_tied_path_opens_the_same_spans():
    """A bucket with its size tied across lanes ('global'), on its tied
    route's plain version: the same seven names and ``solver.gather``
    (the tied route gathers its windows)."""
    _, ranges = _traced(param_mode={"size": "global"},
                        param_val={"size": 2.5}, lm_backend="kernel")
    assert {r[0] for r in ranges} == SPANS | {GATHER}


def test_batch_record_carries_solve_s_and_launches():
    """Each dispatch's ``BatchRecord``: the solve time on the host clock
    (on the CPU), positive and within the call, and an empty ``launches``
    (no kernel launches on the CPU); ``summary()`` totals both,
    ``summary_by_backend()`` keeps its keys."""
    img, f = _dimer_frame()
    with diagnostics.collect() as stats:
        t0 = time.perf_counter()
        ctt.refine_leastsq(f, img, **KW)
        call_s = time.perf_counter() - t0
    assert len(stats.batches) == 2
    for b in stats.batches:
        assert 0 < b.solve_s < call_s
        assert b.launches == {}
    s = stats.summary()
    assert s["solve_s"] == pytest.approx(
        sum(b.solve_s for b in stats.batches))
    assert s["launches"] == {}
    for d in stats.summary_by_backend().values():
        assert set(d) == {"n_clusters", "wall_s", "clusters_per_sec"}


def test_batch_record_counts_the_dispatch_launches(monkeypatch):
    """``launches`` holds what the wrappers' own counters moved during the
    dispatch, also where a caller wraps the name the solver calls: a
    stand-in for ``fused_lm_2d`` that counts on the wrapper's counter as a
    launch on CUDA does, then runs it (the plain version on the CPU),
    gives one launch a refit round per bucket; ``summary()`` adds them
    up."""
    real = refine_mod.fused_lm_2d
    calls = []

    def counted(*a, **k):
        calls.append(1)
        real.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(refine_mod, "fused_lm_2d", counted)
    img, f = _dimer_frame()
    with diagnostics.collect() as stats:
        ctt.refine_leastsq(f, img, lm_backend="kernel", **KW)
    per = [b.launches for b in stats.batches]
    assert len(per) == 2
    assert all(set(p) == {"fused_lm_2d"} and p["fused_lm_2d"] >= 1
               for p in per)
    assert sum(p["fused_lm_2d"] for p in per) == len(calls)
    assert stats.summary()["launches"] == {"fused_lm_2d": len(calls)}


def _bond(pos):
    return torch.stack([((pos[0] - pos[1]) ** 2).sum() - 25.0])


@pytest.mark.parametrize("kw,tags", [
    (dict(lm_backend="kernel", constraints=ctt.dimer(5.0, 2)),
     {"cpu-fused", "cpu-fused-rigid"}),
    (dict(lm_backend="torch", constraints=[
        {"type": "eq", "fun": _bond, "cluster_size": 2}]),
     {"cpu-torch", "cpu-torch-penalty"}),
    (dict(lm_backend="kernel", shards=2), {"cpu-fused-sharded"}),
    (dict(lm_backend="auto", shards=2), {"cpu-torch-sharded"}),
    (dict(lm_backend="kernel", shards=1, param_mode={"size": "global"},
          param_val={"size": 2.5}), {"cpu-tied-global-sharded"}),
    (dict(lm_backend="kernel", shards=2, param_mode={"size": "global"},
          param_val={"size": 2.5}), {"cpu-torch-global-sharded"}),
], ids=["rigid", "penalty", "mesh_kernel", "mesh_auto", "mesh1_tied",
        "mesh2_tied"])
def test_batch_record_tags_each_route(kw, tags):
    """A dispatch's ``backend`` names the route its bucket took on its
    device: the kind of a constrained bucket, ``-sharded`` over a mesh,
    and over several shards a tie's plain route (its sums cross
    devices), also where ``lm_backend='kernel'`` asks for the kernels."""
    kw = dict(kw)
    shards = kw.pop("shards", None)
    if shards:
        kw["mesh"] = make_mesh(["cpu"] * shards)
    img, f = _dimer_frame()
    with diagnostics.collect() as stats:
        ctt.refine_leastsq(f, img, **KW, **kw)
    assert {b.backend for b in stats.batches} == tags


def test_no_solve_clock_without_a_collector(monkeypatch):
    """With no collector active a dispatch reads no counters and sets no
    clock marks."""
    def refuse(*a, **k):
        raise AssertionError("read while nothing collects")

    monkeypatch.setattr(refine_mod, "_clock_mark", refuse)
    monkeypatch.setattr(refine_mod, "_launch_counts", refuse)
    img, f = _dimer_frame()
    out = ctt.refine_leastsq(f, img, **KW)
    assert out["cost"].notna().all()


def test_scipy_spill_records_its_solve_time():
    """Clusters past ``max_cluster_size`` spill to scipy on the host: their
    record's ``solve_s`` is the host clock around the spill."""
    img, f = _dimer_frame()
    with diagnostics.collect() as stats:
        ctt.refine_leastsq(f, img, max_cluster_size=1, **KW)
    spill = [b for b in stats.batches if b.backend == "scipy"]
    assert spill and all(0 < b.solve_s == b.wall_s for b in spill)
    assert all(b.launches == {} for b in spill)


TRACK_SPANS = ("track.locate", "track.find", "track.refine", "track.link")


class _Video:
    """Four 96² frames of three dimers and a single, drifting by 0.3 px a
    frame, with read noise of σ 2."""

    def __init__(self, n_frames=4):
        rng = np.random.default_rng(3)
        self.frames = []
        for t in range(n_frames):
            img = np.zeros((96, 96))
            for center, n in [((25, 25), 2), ((25, 70), 2), ((70, 30), 2),
                              ((70, 70), 1)]:
                artificial.draw_cluster(
                    img, (center[0] + 0.3 * t, center[1] - 0.2 * t),
                    size=1.6, separation=5.0, n=n, signal=150.0,
                    angle=0.5 + 0.05 * t)
            self.frames.append(img + rng.normal(0.0, 2.0, img.shape))

    def __getitem__(self, t):
        return self.frames[t]

    def __len__(self):
        return len(self.frames)


TRACK_KW = dict(diameter=9, separation=6, search_range=3.0, memory=1,
                device="cpu")


def _traced_track(**kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ctt.track(_Video(), **{**TRACK_KW, **kw})
    return out, _ranges(prof)


def test_track_opens_its_four_spans_in_order():
    """A single-shot ``track`` opens ``track.locate``, ``track.find``,
    ``track.refine`` and ``track.link`` once each, one after another in
    that order; every ``refine.*`` and ``solver.*`` range lies inside
    ``track.refine`` (``refine.find`` stays shut: the table comes with
    its clusters from ``track.find``)."""
    out, ranges = _traced_track(link_backend="device")
    assert len(out)
    stages = sorted((r for r in ranges if r[0] in TRACK_SPANS),
                    key=lambda r: r[1])
    assert [r[0] for r in stages] == list(TRACK_SPANS)
    for a, b in zip(stages, stages[1:]):
        assert a[2] <= b[1]
    refine_range = stages[2]
    inner = [r for r in ranges if r[0] in SPANS]
    assert {r[0] for r in inner} == SPANS - {"refine.find"}
    for r in inner:
        assert _inside(r, refine_range), r


def test_track_span_args_carry_the_sizes(monkeypatch):
    """The ranges' ``args``: the frames located, the features found, the
    link backend asked for and the features linked; ``track.refine`` has
    none."""
    opened = _recording(monkeypatch)
    out = ctt.track(_Video(), link_backend="device", **TRACK_KW)
    by = {name: args for name, args in opened if name in TRACK_SPANS}
    assert by["track.locate"] == "frames=4"
    assert by["track.find"] == f"features={len(out)}"
    assert by["track.refine"] is None
    assert by["track.link"] == f"backend=device features={len(out)}"


def test_checkpointed_track_opens_the_spans_once_a_chunk(tmp_path):
    """``checkpoint_dir`` with two frames a chunk: each of the four ranges
    opens once a chunk, in order within the chunk, the link's with the
    host ``Linker``."""
    _, ranges = _traced_track(checkpoint_dir=str(tmp_path),
                              checkpoint_every=2)
    stages = sorted((r for r in ranges if r[0] in TRACK_SPANS),
                    key=lambda r: r[1])
    assert [r[0] for r in stages] == list(TRACK_SPANS) * 2


@pytest.mark.parametrize("backend", ["device", "device-binned", "host"])
def test_track_ledger_counts_the_auction(backend):
    """After a device auction, dense or binned, the ledger holds its rounds
    and host syncs summed over the frames (the linker's ``last_stats``);
    the host ``Linker`` runs no auction and adds neither."""
    from clustertracking_tpu_torch.ops.link import (
        link_on_device, link_on_device_binned)

    with diagnostics.collect() as stats:
        ctt.track(_Video(), link_backend=backend, **TRACK_KW)
    led = stats.ledger
    assert led["link_backend"] == backend
    if backend == "host":
        assert "link_rounds" not in led and "link_syncs" not in led
        return
    last = (link_on_device if backend == "device"
            else link_on_device_binned).last_stats
    assert last["frames"] == 4
    assert led["link_rounds"] == sum(last["rounds"]) >= 4
    assert led["link_syncs"] == sum(last["syncs"]) >= 1


# -------------------------------------------------------------------- card

@pytest.mark.cuda
def test_batch_record_on_the_card():
    """On CUDA: ``solve_s`` is the device time between the dispatch's
    events, positive and within the call; ``launches`` holds the
    ``fused_lm_2d`` launches the wrapper's counter moved by; and a CUDA
    profiler trace holds the seven ranges with the card's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clustertracking_tpu_torch.ops.fused_lm import fused_lm_2d

    img, f = _dimer_frame()
    kw = {**KW, "device": "cuda"}
    ctt.refine_leastsq(f, img, **kw)          # build, warm
    before = fused_lm_2d.launches
    with diagnostics.collect() as stats:
        t0 = time.perf_counter()
        ctt.refine_leastsq(f, img, **kw)
        call_s = time.perf_counter() - t0
    assert {b.backend for b in stats.batches} == {"cuda-fused"}
    for b in stats.batches:
        assert 0 < b.solve_s < call_s
        assert set(b.launches) == {"fused_lm_2d"}
    assert (sum(b.launches["fused_lm_2d"] for b in stats.batches)
            == fused_lm_2d.launches - before)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ctt.refine_leastsq(f, img, **kw)
        torch.cuda.synchronize()
    assert {r[0] for r in _ranges(prof) if "." in r[0]} >= SPANS


@pytest.mark.cuda
def test_gathered_route_names_its_mode_on_the_card(monkeypatch):
    """On CUDA config 4's bucket takes the gathered route: a trace holds
    ``window_gather_kernel`` and ``pixel_lm_kernel``, ``solver.gather``
    inside ``solver.kernel``, and ``solver.kernel``'s ``args`` name the
    mode ``pixel_lm`` launched, the one ``launch_mode`` picks by occupancy
    for 9x13x13 at V = 14 (streamed: its tensor-core sums leave the
    registers room for more warps than resident's shared memory), and its
    sums, ``f64_mma``, each launch counted in that mode's counter and in
    ``launches_mma``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from clustertracking_tpu_torch.entry import MODES_3D, WINDOW_3D
    from clustertracking_tpu_torch.models import build_layout, get_model
    from clustertracking_tpu_torch.ops.pixel_lm import launch_mode, pixel_lm

    lay = build_layout(get_model("gauss"), 3, False, 2, dict(MODES_3D))
    mode = launch_mode(get_model("gauss"), lay, None, WINDOW_3D, "cuda")
    solve, args = _solve_3d("auto", "cuda")
    solve(*args)                               # build, warm
    counter = f"launches_{mode}"
    launched, mma = getattr(pixel_lm, counter), pixel_lm.launches_mma
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(*args)
        torch.cuda.synchronize()
    assert getattr(pixel_lm, counter) > launched
    assert (pixel_lm.launches_mma - mma
            == getattr(pixel_lm, counter) - launched)
    kernels = {e.name() for e in prof.profiler.kineto_results.events()}
    assert any("pixel_lm_kernel" in k for k in kernels)
    assert any("window_gather_kernel" in k for k in kernels)
    opened = _recording(monkeypatch)
    solve(*args)
    assert ("solver.kernel",
            f"route=gathered mode={mode} sums=f64_mma") in opened
    assert (GATHER, "B=8 window=9x13x13") in opened
