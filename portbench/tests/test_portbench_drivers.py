"""Each cell's run, through the harness's own function, at a size the host
can hold: the port's plain route on the CPU agrees with the benchmark's
reference, and nothing of JAX or the JAX package is loaded."""
import pytest

import core


def driver_module(cell):
    """The module of ``cell``'s driver: its ``make``, and the hooks its
    tests read (``HOST_TRAFFIC``, ``plant``)."""
    return core.load_module("drivers", cell["driver"])


def cells():
    import json

    b = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in b["workloads"]]


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_host(workload, trace):
    cell, _ = core.load_cell(workload)
    res, checks = core.execute(workload, 2**31 + 11, 0.3, trace,
                               device="cpu",
                               traffic=driver_module(cell).HOST_TRAFFIC)
    assert res["correct"], res["check"]
    names = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(res["metrics"]) <= set(names)
    assert list(res)[-1] == "check"
    assert {c.name for c in checks} == set(cell["check"]["limits"])
    if not trace:
        assert set(res["metrics"]) == set(names)
    assert core.forbidden_modules() == []


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_cell_runs_correct_on_the_card(workload, card):
    res, _ = core.execute(workload, 7, 2.0, False, device=card)
    assert res["correct"], res["check"]
    assert core.forbidden_modules() == []
