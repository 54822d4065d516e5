"""Metric logging and tracing.

`MetricWriter`: JSONL always, TensorBoard when available (the port's own
copy of checkerpose_tpu/utils/logging.py::MetricWriter; same scalar names and
file format).

`span(name, device)`: a named piece of the program's work. Spans are on only
while torch.profiler records; otherwise `span` checks that one flag and
returns a shared no-op. On, a span opens `record_function(name)` (a host
range in the profiler's trace, on its clock, among the kernels), keeps a
`SpanRecord` in memory and, on a CUDA device, records a pair of timing events
on the current stream (no synchronisation). The program opens these, nested
as listed:

    serving.call         ServingPipeline.__call__: upload, forward, decode, solver
      posenet            PoseNet.forward
        posenet.backbone   InitNet.forward: the backbone's feature maps
        posenet.init_head  InitNet.forward: 1x1 convs, init EdgeConvs, bit MLP
        posenet.stage      one per active stage: up_i (and its aux head), refine_i
        posenet.seg        the seg head
      decode             the ids to 2D-3D correspondences (serving and eval)
      solver             ransac_pnp: the whole robust solve
        solver.hypotheses  sampling, hypothesis EPnP and scoring
        solver.refine      IRLS, Gauss-Newton and reseed EPnP
    serving.to_host      ServingPipeline.stream: one batch's copy to the host
    eval.loader          evaluate_pipeline: each wait on the loader
    eval.batch           evaluate_pipeline: one batch, once it is in hand
      eval.forward_decode, eval.solver_metrics, eval.aggregate
    train.step           a train step (pose, pretrain, NOCS)
      train.augment      augmentation and normalisation
      train.forward      the net's forward and the losses
      train.backward     zeroing the gradients, backward
      train.optimizer    zero fill of unreached gradients, all-reduce, step()

To trace a run, wrap a few batches or steps of it in `profiler(dir)`:

    with profiler("traces/serve"):             # a serving run
        for out in pipe.stream(batches, generator):
            ...
    with profiler("traces/train"):             # a training run
        for batch in batches:
            step(state, batch, generator)

`<dir>/trace.json` is the Chrome trace (chrome://tracing, Perfetto): the
spans' host ranges among the operators and kernels. `<dir>/spans.json` holds,
per span name, its count and its total host ms and device ms (null without
a card). A span's device ms is the interval between its two events on the
stream: where the host paces the span, it includes the device's waits for
the host; the trace's gaps inside the span's host range are those waits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:                  # the tensorboard package is optional
                pass
            else:
                self.tb = SummaryWriter(log_dir)

    def add_scalar(self, name: str, value: float, step: int):
        self.add_scalars({name: value}, step)

    def add_scalars(self, scalars: dict, step: int):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


@dataclasses.dataclass
class SpanRecord:
    """One instance of a span: its name, its host start and end
    (time.perf_counter seconds; end None while open) and, on a CUDA device,
    its (start, end) timing events."""
    name: str
    host_start: float
    host_end: Optional[float] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None


# the records of the spans opened while the profiler recorded, oldest first;
# bounded, so that a process profiled again and again keeps the latest
_RECORDS: deque = deque(maxlen=1 << 16)
_OFF = contextlib.nullcontext()


class _Span:
    def __init__(self, name: str, device):
        self.name = name
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        rec = self.rec = SpanRecord(self.name, time.perf_counter())
        if self.device is not None:
            stream = torch.cuda.current_stream(self.device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(stream)
        _RECORDS.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        rec.host_end = time.perf_counter()
        self.range.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A span around the block (module docstring); `device` is where the
    block's work runs (timing events only for a CUDA device)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name, device)


def span_records() -> List[SpanRecord]:
    """The records in memory, oldest first (a copy of the list)."""
    return list(_RECORDS)


def drain_spans() -> List[SpanRecord]:
    """The records in memory, oldest first; the memory is emptied."""
    out = list(_RECORDS)
    _RECORDS.clear()
    return out


def resolve_spans(records: List[SpanRecord]) -> List[Dict]:
    """{name, host_ms, device_ms} of each closed record, in order;
    device_ms is None without timing events. Waits for the device once."""
    closed = [r for r in records if r.host_end is not None]
    if any(r.events is not None for r in closed):
        torch.cuda.synchronize()
    return [{"name": r.name, "host_ms": 1e3 * (r.host_end - r.host_start),
             "device_ms": (None if r.events is None
                           else r.events[0].elapsed_time(r.events[1]))}
            for r in closed]


def span_summary(records: List[SpanRecord]) -> Dict[str, Dict]:
    """Per span name: count, total host ms and total device ms (None where
    no instance had timing events)."""
    out: Dict[str, Dict] = {}
    for r in resolve_spans(records):
        s = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += r["host_ms"]
        if r["device_ms"] is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r["device_ms"]
    return out


@contextlib.contextmanager
def profiler(trace_dir: Optional[str]):
    """torch.profiler over the block (the CPU, and the card where CUDA is
    available), which turns the spans on: the Chrome trace goes to
    `<trace_dir>/trace.json` and the block's spans to
    `<trace_dir>/spans.json` (`span_summary`). Does nothing for None
    (counterpart of the JAX package's jax.profiler scope)."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    drain_spans()                               # records of earlier profiling
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump(span_summary(drain_spans()), f, indent=1)
