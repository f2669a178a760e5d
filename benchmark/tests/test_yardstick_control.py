"""The control of each cell's check: the plain reference computed in fp8
(the step below the configurations' bf16) in the program's place must come
out not correct.  On the card at the cell's own size on three seeds; on the
CPU at tiny sizes, where the program computes in f32, its readings must lie
far above the program's."""

import pytest

from benchmark import calibrate, harness
from benchmark.tests.tiny import shrink_of

CELLS = [w["name"] for w in harness.spec()["workloads"]]
MAIN = {"generate": "image_rel_l2", "train": "grad_gap"}


def readings(ctx):
    return {n: v for n, v, _ in ctx.checks}


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program_tiny(cell):
    program = calibrate.program_run(cell, 4_000_000_007, 0.3, "cpu", shrink_of(cell))
    control = calibrate.control_run(cell, 4_000_000_007, 0.3, "cpu", shrink_of(cell))
    name = MAIN[program.traffic["driver"]]
    assert program.correct
    assert readings(control)[name] > 1000 * max(readings(program)[name], 1e-9)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, card):
    for seed in (5_000_000_001, 5_000_000_002, 5_000_000_003):
        ctx = calibrate.control_run(cell, seed, 2.0, card)
        assert not ctx.correct, (cell, seed, ctx.checks)
