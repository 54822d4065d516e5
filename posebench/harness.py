"""One run of one cell: set-up, the measured window, the traced phases, the
comparison with the reference, and the result line.

A cell is a `workloads` entry of BENCHMARK.json at the checkout's root: a
configuration file (`configs/<config>.json`), a traffic file
(`traffic/<traffic>.json`, whose `loop` names the module under `loops/`
that reads it) and the limits of its comparison (`limits/<workload>.json`).
Each per-layer metric is a reader `metrics/<name>.py` with `read(ctx)`.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BANNED = ("jax", "jaxlib", "flax", "checkerpose_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((PKG / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"posebench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


@dataclasses.dataclass
class Context:
    """What one run hands its loop and its metric readers."""
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: object
    t_start: float
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, object] = dataclasses.field(default_factory=dict)
    trace: object = None               # trace.Trace of the traced sub-window
    launch_trace: object = None        # trace.Trace of one synchronous unit
    rate: Optional[float] = None       # items / s over the window
    flops_per_item: Optional[float] = None
    peak_bytes: Optional[int] = None


def _device_info(ctx: Context) -> dict:
    import torch
    dev = ctx.device
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), ctx.cell.chips
    else:
        kind, count = "cpu", 1
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind, "count": count,
            "memory_peak_bytes": int(ctx.peak_bytes or 0)}
    if ctx.traced and ctx.trace is not None:
        info["busy_s"] = ctx.trace.busy_s
        info["window_s"] = ctx.trace.window_s
    return info


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """One run; returns (the result object, the compared numbers as
    (name, value, limit))."""
    import torch
    from posebench import flops, trace as tr

    loop_mod = importlib.import_module(f"posebench.loops.{cell.traffic['loop']}")
    ctx = Context(cell, seed, seconds, traced, device, t_start)
    loop = loop_mod.Loop(ctx)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    e2e, attempted, failed = loop.window(seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        ctx.peak_bytes = torch.cuda.max_memory_allocated(device)
    ctx.rate = loop.rate
    metrics = {}
    if traced:
        loop.instrumented()
        ctx.launch_trace = tr.profiled(loop.one_unit, device)
        ctx.trace = tr.profiled(loop.traced_units, device)
        ctx.flops_per_item = (flops.train_flops(cell.config["model"]) if loop.training
                              else flops.forward_flops(cell.config["model"],
                                                       loop.per_sample_graph))
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = loop.check()
    loop.close()
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": _device_info(ctx)}
    if traced and ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks


def main(argv=None, start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if start is None else start
    p = argparse.ArgumentParser(description="run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"posebench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = run(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    found = banned_modules()
    if found:
        print(f"posebench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
