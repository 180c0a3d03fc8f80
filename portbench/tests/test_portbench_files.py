"""Every file the benchmark finds by name loads and keeps the contract's
character rules, and BENCHMARK.json agrees with them."""
import json
import re

import pytest

import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ROOT = core.ROOT


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_files_load(kind):
    for entry in bench()[kind]:
        name = entry["name"]
        if kind == "configs":
            cfg = json.loads((ROOT / entry["file"]).read_text())
            assert cfg["name"] == name
            assert cfg["reduced"] == entry["reduced"]
            assert cfg["source"] == entry["source"]
        else:
            cell, cfg = core.load_cell(name)
            assert cell["config"] == entry["config"] == cfg["name"]
            assert cell["traffic"] == entry["traffic"]
            assert NAME.match(cell["traffic"])
            assert cell["chips"] == entry["chips"] == 1
            assert cell["why"] == entry["why"]
            core.load_json(core.BENCH / "traffic" / f"{cell['traffic']}.json")
            core.load_module("drivers", cell["driver"])


def test_metric_readers_and_cells_agree():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    per = {m["name"]: m for m in b["per_layer"]}
    for w in b["workloads"]:
        cell, _ = core.load_cell(w["name"])
        for m in cell["end_to_end"]:
            assert w["name"] in e2e[m].get("workloads", [w["name"]])
        for m in cell["per_layer"]:
            assert w["name"] in per[m].get("workloads", [w["name"]])
        for name in cell["end_to_end"] + cell["per_layer"]:
            reader = core.load_module("metrics", name)
            unit = (e2e.get(name) or per[name])["unit"]
            assert reader.UNIT == unit, name
        assert "setup_s" in cell["end_to_end"]
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in b["end_to_end"]:
        for cellname in m.get("workloads", []):
            assert m["name"] in core.load_cell(cellname)[0]["end_to_end"]


def test_every_moves_target_is_reported_by_its_cells():
    b = bench()
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for cellname in m["workloads"]:
            cell, _ = core.load_cell(cellname)
            assert m["moves"] in cell["end_to_end"], (m["name"], cellname)
            assert m["name"] in cell["per_layer"]


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_driver_module_carries_its_hooks(workload):
    """What the harness and the tests read from a cell's driver module, so
    that a cell with a new driver needs no edit of a test."""
    cell, _ = core.load_cell(workload)
    driver = cell["driver"]
    mod = core.load_module("drivers", driver)
    for hook in ("make", "plant"):
        assert callable(getattr(mod, hook, None)), (
            f"driver {driver!r} has no callable {hook!r}")
    host = getattr(mod, "HOST_TRAFFIC", None)
    assert isinstance(host, dict), (
        f"driver {driver!r} has no dict 'HOST_TRAFFIC'")
    extra = sorted(set(host) - set(cell["mix"]))
    assert not extra, (f"driver {driver!r}'s 'HOST_TRAFFIC' has {extra}, "
                       f"which traffic {cell['traffic']!r} lacks")
