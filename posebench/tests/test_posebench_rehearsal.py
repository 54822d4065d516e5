"""Every cell's loop and metric readers, rehearsed on the CPU at a tiny
size: a run ends correct, with the result line a run prints."""
import json

import numpy as np
import pytest

from posebench import capture, harness
from posebench.tests.tiny import run_tiny, workloads

WORKLOADS = workloads()
HOST_READERS = {"forward_ms.pose", "solver_ms.pose", "queue_wait_ms.open", "batch_crops.open"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_untraced_run_reports_the_cells_end_to_end_metrics(workload):
    result, checks = run_tiny(workload, seed=2 ** 31 + 11)
    cell = harness.load_cell(workload)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reads_what_the_cpu_can_give(workload):
    result, _ = run_tiny(workload, seed=17, traced=True)
    cell = harness.load_cell(workload)
    assert result["correct"], result["checks"]
    names = {m["name"] for m in cell.per_layer}
    # device readings are left out off the card; host spans and counters stay
    assert set(result["metrics"]) == names & HOST_READERS
    assert result["device"]["platform"] == "cpu"
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_the_open_loop_judges_requests_crops_and_not_its_padding():
    import time

    import torch

    from posebench.loops import serve_open
    from posebench.tests.tiny import tiny_cell
    cell = tiny_cell("hr18_lmo.serve_open")
    ctx = harness.Context(cell, 5, 1.0, False, torch.device("cpu"), time.perf_counter())
    d = serve_open.Loop(ctx)
    d.setup()
    d.window(1.0)
    records = d.cap.records()
    assert records
    for rec in records:
        real = rec["meta"]["real"]
        assert 0 < real <= rec["x_id"].shape[0]
        rows = capture._sample(rec, rec["meta"], 64, np.random.default_rng(0), lambda x: x)[0]
        assert int(rows.max()) < real
    assert any(rec["meta"]["real"] < rec["x_id"].shape[0] for rec in records)
    d.close()
