"""The control: the plain reference computed in the precisions below the
configuration's (TF32 operands in every sum over pixels; bfloat16
arithmetic) and put in the program's place, fails at least one of the
cell's numbers.  On the host at a tiny size; ``-m cuda`` at the cell's
own size on three seeds."""
import pytest

import control
import core
from test_portbench_drivers import cells, driver_module


def fails(workload, row, prec):
    cell, _ = core.load_cell(workload)
    limits = cell["check"]["limits"]
    return [n for n, lim in limits.items() if not row[prec][n] <= lim]


@pytest.mark.parametrize("workload", cells())
def test_control_fails_on_the_host(workload):
    cell, _ = core.load_cell(workload)
    row = control.readings(workload, 5, 0.3, ("tf32", "bfloat16"),
                           device="cpu",
                           traffic=driver_module(cell).HOST_TRAFFIC)
    limits = cell["check"]["limits"]
    assert all(row["program"][n] <= lim for n, lim in limits.items())
    for prec in ("tf32", "bfloat16"):
        assert fails(workload, row, prec), (prec, row[prec])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_control_fails_on_the_card(workload, seed, card):
    row = control.readings(workload, seed, 2.0, ("tf32", "bfloat16"),
                           device=card, tables=8)
    for prec in ("tf32", "bfloat16"):
        assert fails(workload, row, prec), (prec, row[prec])
