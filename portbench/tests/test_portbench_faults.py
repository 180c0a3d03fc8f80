"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (the run is on the host, at a
tiny size; ``-m cuda``: on the card, at the cell's own size); the
program's entry is wrapped so that each call suffers one
fault the cell can have: a step that returns its state unchanged, half
of the batch left out, or one answer altered where it is produced.  The
exchange between chips is no fault of these one-chip cells."""
import json

import pytest

import core
from test_portbench_drivers import SMALL

ALTER_PX = 0.01   # one answer moved by a hundredth of a pixel


def broken_solve(solve, fault):
    def call(frames, fidx, params0, pose0, valid):
        if fault == "half":
            keep = valid.clone()
            keep[len(keep) // 2:] = False
            return solve(frames, fidx, params0, pose0, keep)
        out = list(solve(frames, fidx, params0, pose0, valid))
        if fault == "unchanged":
            out[0] = params0.clone()
        else:
            out[0] = out[0].clone()
            out[0][0, 0, 3] += ALTER_PX
        return tuple(out)
    return call


def broken_refine(refine, fault):
    def call(table, frame, **kw):
        if fault == "half":
            half = table.iloc[: len(table) // 2]
            out = table.copy()
            out["cost"] = float("nan")
            out["fit_converged"] = False
            out["cluster"] = range(len(out))
            done = refine(half, frame, **kw)
            out.loc[done.index, done.columns] = done
            return out
        out = refine(table, frame, **kw)
        if fault == "unchanged":
            out[["y", "x"]] = table[["y", "x"]].to_numpy()
        else:
            out.loc[out.index[0], "x"] += ALTER_PX
        return out
    return call


def planted(fault):
    def make(cell, config, seed, device):
        driver = core.load_module("drivers", cell["driver"]).make(
            cell, config, seed, device)
        if cell["driver"] == "solve":
            driver.solve = broken_solve(driver.solve, fault)
        else:
            driver.refine = broken_refine(driver.refine, fault)
        return driver
    return make


def cells():
    b = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in b["workloads"]]


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_path_is_not_correct(workload, fault):
    cell, _ = core.load_cell(workload)
    res, checks = core.execute(workload, 3, 0.3, False, device="cpu",
                               traffic=SMALL[cell["driver"]],
                               make_driver=planted(fault))
    assert res["correct"] is False, res["check"]
    assert any(not c.ok for c in checks)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("seed", [201, 202, 203])
def test_a_broken_path_is_not_correct_on_the_card(workload, fault, seed,
                                                  card):
    """At the cell's own size: every table or frame of the pool is called
    and compared, so an altered answer is one lane or row of each."""
    res, checks = core.execute(workload, seed, 8.0, False, device=card,
                               make_driver=planted(fault))
    print(json.dumps({"workload": workload, "fault": fault, "seed": seed,
                      "check": res["check"]}))
    assert res["correct"] is False, res["check"]
