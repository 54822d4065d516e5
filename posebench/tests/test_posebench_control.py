"""The control (the reference with float8 products in the program's place)
fails the cell's comparison where the program passes: at a tiny size on
the CPU, and, on the card, at the cell's own size on three seeds."""
import importlib
import time

import pytest
import torch

from posebench import harness
from posebench.tests.tiny import tiny_cell, workloads

WORKLOADS = workloads()


def _readings(cell, seed, seconds, device):
    mod = importlib.import_module(f"posebench.loops.{cell.traffic['loop']}")
    d = mod.Loop(harness.Context(cell, seed, seconds, False, device, time.perf_counter()))
    d.setup()
    d.window(seconds)
    program = {k: v for k, v, _ in d.check()}
    control = d.control()
    d.close()
    return program, control


def _fails(numbers, limits):
    return any(not (numbers[k] <= lim) for k, lim in limits.items() if k in numbers)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_where_the_program_passes_on_the_cpu(workload):
    cell = tiny_cell(workload)
    program, control = _readings(cell, 31, 0.5, torch.device("cpu"))
    limits = cell.limits["limits"]
    assert not _fails(program, limits), program
    assert _fails(control, limits), control


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(card, workload):
    cell = harness.load_cell(workload)
    for seed in (101, 102, 103):
        program, control = _readings(cell, seed, 3.0, card)
        limits = cell.limits["limits"]
        assert not _fails(program, limits), (seed, program)
        assert _fails(control, limits), (seed, control)
