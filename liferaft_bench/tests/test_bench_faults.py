"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run (set-up, the window, the batch in
flight, the check) on the CPU at a tiny cut, the chip's look skipped, with
one fault planted in the served step: the state left unchanged (no K/V
written), half of the batch left out (its rows neither written nor
decoded, their tokens copied from the rest), or a token altered where it
is produced.  The exchange between chips does not exist in a one-card
cell.  The sound run beside them comes out correct.  The MoE cut is held
to the mixtral cell's own limits and routing margin (its
``limits/<cell>.json``); ``control.py --fault`` plants the same faults at
the cell's own size on the card."""
import pytest

from liferaft_bench import manifest, run
from liferaft_bench.faults import FAULTS

from .conftest import MOE_CELL, TINY_DENSE, TINY_MOE, tiny_cell
from .test_bench_reference import BF16_LIMITS


def _run(bench, cell, hook):
    return run.run_cell(bench, cell, 2**31 + 99, 0.3, False, "cpu", 0.0,
                        log=lambda *a: None, server_hook=hook)


@pytest.mark.parametrize("config,name", [(TINY_DENSE, None),
                                         (TINY_MOE, MOE_CELL)],
                         ids=["dense", "moe"])
@pytest.mark.parametrize("fault", [None, *FAULTS], ids=["sound", *FAULTS])
def test_fault_comes_out_not_correct(bench, config, name, fault):
    limits = manifest.cell(bench, name).limits if name else BF16_LIMITS
    cell = tiny_cell(config, limits, **({"name": name} if name else {}))
    r = _run(bench, cell, FAULTS.get(fault))
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"
