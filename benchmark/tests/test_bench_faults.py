"""Each fault a cell can have, planted in the program under a whole run
(the look for a card skipped, on the CPU at a tiny size), turns ``correct``
false: the check sees it."""

import pytest

from benchmark import run
from benchmark.tests.faults import FAULTS
from benchmark.tests.tiny import ROOT, TINY, root_with_training

CASES = [(cell, name) for cell, faults in FAULTS.items() for name in faults]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_makes_the_run_not_correct(cell, fault, tmp_path):
    root = ROOT if cell == "rap_12.pairs-serve" else root_with_training(tmp_path)
    with FAULTS[cell][fault]():
        result, compared = run.run(cell, 2**32 + 99, 0.3, False, device="cpu",
                                   overrides=TINY[cell], root=root)
    assert not result["correct"], compared
    # the same run without the fault is correct
    result, compared = run.run(cell, 2**32 + 99, 0.3, False, device="cpu", overrides=TINY[cell],
                               root=root)
    assert result["correct"], compared
