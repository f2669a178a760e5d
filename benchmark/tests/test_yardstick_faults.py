"""The check that decides `correct` against a broken program: each run skips
the look for a card and drives the rest of a cell's run at tiny sizes on the
CPU, with the timed path broken underneath (`calibrate.FAULTS`), and
`correct` must come out false.  One case for each fault a cell can have (the
exchange between chips is not one: every cell takes one chip; nor is half a
batch in generation, which takes no mean over it)."""

import pytest

from benchmark import calibrate, harness
from benchmark.tests.tiny import shrink_of

CASES = [(w["name"], fault) for w in harness.spec()["workloads"]
         for fault in calibrate.FAULTS[harness.load_json("traffic", w["traffic"])["driver"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    driver = harness.load_json("traffic", harness.cell(cell)["traffic"])["driver"]
    with calibrate.planted(driver, fault):
        ctx = calibrate.program_run(cell, 77_000_000_001, 0.3, "cpu", shrink_of(cell))
    assert not ctx.correct, ctx.checks
    assert calibrate.program_run(cell, 77_000_000_001, 0.3, "cpu", shrink_of(cell)).correct
