"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have (posebench/faults.py), planted before set-up, at a
tiny size on the CPU under the cell's own limits."""
import time

import pytest
import torch

from posebench import faults, harness
from posebench.tests.tiny import tiny_cell

INFERENCE = ("hr18_lmo.serve_b512", "res34_lm.eval_b512", "hr18_lmo.serve_open")
CASES = ([(w, f) for w in INFERENCE for f in ("altered_pose", "altered_bit", "half_batch")]
         + [("hr18_lmo.train_b128", f) for f in ("half_batch", "unchanged")])


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_makes_the_run_not_correct(workload, fault):
    cell = tiny_cell(workload)
    with faults.FAULTS[fault]():
        result, checks = harness.run(cell, 23, 0.5, False, torch.device("cpu"),
                                     time.perf_counter())
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", INFERENCE + ("hr18_lmo.train_b128",))
def test_the_same_run_without_a_fault_is_correct(workload):
    result, checks = harness.run(tiny_cell(workload), 23, 0.5, False, torch.device("cpu"),
                                 time.perf_counter())
    assert result["correct"], checks
