"""Tiny cells for the CPU rehearsals: each benchmark cell's configuration
with a few channels, keypoints and crops (the backbones whole), its
traffic cut to a few batches or steps, and its own limits."""
from __future__ import annotations

import copy
import json
import time

import torch

from posebench import harness

TINY_MODEL = {"npoint": 64, "num_filters": 32, "query_dims": [32, 32, 16]}
TINY_TRAFFIC = {
    "serve_stream": {"batch": 8, "pool_batches": 2, "warm_batches": 1, "span_batches": 1,
                     "trace_warm": 1, "trace_batches": 1},
    "eval_lm": {"batch": 8, "pool_batches": 2, "warm_calls": 1, "span_calls": 1,
                "trace_warm": 1, "trace_calls": 1},
    "train": {"batch": 8, "pool_batches": 3, "warm_steps": 3, "span_steps": 1,
              "trace_warm": 1, "trace_steps": 1},
    "serve_open": {"batch": 4, "pool_batches": 2, "warm_batches": 1, "span_batches": 1,
                   "mean_crops_per_s": 48, "shapes": [8, 16, 32], "max_batch": 32,
                   "trace_warm_s": 0.2, "trace_s": 0.5, "drain_s": 10.0},
}


def workloads():
    """Every cell of BENCHMARK.json: a cell that a later change adds is
    rehearsed, faulted and controlled with no edit to the tests."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def tiny_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config["model"].update(TINY_MODEL)
    cell.config["knn_k"] = 8
    cell.config["objects"] = min(cell.config["objects"], 3)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["loop"]])
    if "sample" in cell.limits:
        cell.limits["sample"].update({"batches": 4, "rows": 8, "block": 8})
    return cell


def run_tiny(name: str, seed: int, traced: bool = False, seconds: float = 0.5):
    return harness.run(tiny_cell(name), seed, seconds, traced, torch.device("cpu"),
                       time.perf_counter())
