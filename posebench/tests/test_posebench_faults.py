"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have (posebench/faults.py), planted before set-up, at a
tiny size on the CPU under the cell's own limits."""
import time

import pytest
import torch

from posebench import faults, harness
from posebench.tests.tiny import tiny_cell, workloads

# the faults each kind of loop can have
TRAINING_FAULTS = ("half_batch", "unchanged")
PER_SAMPLE_TRAINING_FAULTS = TRAINING_FAULTS + ("other_objects",)
INFERENCE_FAULTS = ("altered_pose", "altered_bit", "half_batch")
WORKLOADS = workloads()


def _faults(workload):
    cell = harness.load_cell(workload)
    if cell.traffic["loop"] != "train":
        return INFERENCE_FAULTS
    return PER_SAMPLE_TRAINING_FAULTS if cell.config["objects"] > 1 else TRAINING_FAULTS


CASES = [(w, f) for w in WORKLOADS for f in _faults(w)]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_makes_the_run_not_correct(workload, fault):
    cell = tiny_cell(workload)
    with faults.FAULTS[fault]():
        result, checks = harness.run(cell, 23, 0.5, False, torch.device("cpu"),
                                     time.perf_counter())
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_same_run_without_a_fault_is_correct(workload):
    result, checks = harness.run(tiny_cell(workload), 23, 0.5, False, torch.device("cpu"),
                                 time.perf_counter())
    assert result["correct"], checks
