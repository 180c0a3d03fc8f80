"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (the run is on the host, at a
tiny size; ``-m cuda``: on the card, at the cell's own size); the
program's entry is wrapped (by the driver module's ``plant``) so that
each call suffers one fault the cell can have: a step that returns its
state unchanged, half of the batch left out, or one answer altered where
it is produced.  The exchange between chips is no fault of these one-chip
cells."""
import json

import pytest

import core
from test_portbench_drivers import cells, driver_module


def planted(fault):
    """A ``make`` that builds the cell's driver and plants ``fault`` in it
    through the driver module's own ``plant``."""
    def make(cell, config, seed, device):
        mod = driver_module(cell)
        driver = mod.make(cell, config, seed, device)
        mod.plant(driver, fault)
        return driver
    return make


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_path_is_not_correct(workload, fault):
    cell, _ = core.load_cell(workload)
    res, checks = core.execute(workload, 3, 0.3, False, device="cpu",
                               traffic=driver_module(cell).HOST_TRAFFIC,
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
