"""On a card (skipped without one): a small cell is correct, its trace links
the kernels to their ranges and agrees with the program's launch counters,
and the control, the reference with TF32 in the program's place, is not
correct."""

import pytest

from portbench import harness
from portbench.tests.conftest import LIVE, REPLAY, drive, small_cell

SEED = 2**31 + 301


@pytest.mark.cuda
@pytest.mark.parametrize("name", [LIVE, REPLAY])
def test_small_cell_is_correct_on_the_card(card, name):
    correct, numbers, _ = drive(name, SEED, device=card)
    assert correct, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", [LIVE, REPLAY])
def test_control_is_not_correct(card, name):
    cell = small_cell(name)
    run = harness.load_driver(cell.traffic["kind"]).Run(cell, SEED, card)
    run.setup()
    controls = run.control(24)
    assert not all(harness.decide(n, cell.limits)[0] for n in controls.values()), controls


@pytest.mark.cuda
def test_trace_links_kernels_to_ranges(card):
    cell = small_cell(LIVE)
    cell.traffic["trace_frames"] = 4
    run = harness.load_driver(cell.traffic["kind"]).Run(cell, SEED, card, trace=True)
    run.setup()
    run.window(1.0)
    s = run.summary
    assert s is not None and s.agreed and s.linked > 0.99
    assert s.range_stat("detector.detect", "device_s") > 0
    assert s.kernel_s("nms_")[0] == 4 and s.kernel_s("crops_")[0] == 4
