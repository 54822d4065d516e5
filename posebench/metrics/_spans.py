"""Readings of the program's spans (checkerpose_tpu_torch/utils/logging.py
`span`) over a run's traced stretch, `ctx.trace`, the last profiled call.

The spans' host ranges are among the trace's `host_ops`, on the device
trace's clock. A span's instances in the stretch: of the program's records
of that name, the last m, where m is the count of the name's host ranges in
the trace (the profiled call's own, matched to them in order of start); of
those, the ones whose host range starts inside the traced window.

Device ms of an instance: the time the device ran its work. Its pair of
CUDA events bounds its interval on the running stream; less the device's
idle while the host was inside the instance. On one stream that idle lies
wholly inside the interval (an idle device has reached every event recorded
before, and none that the host has yet to record), and the interval holds no
other idle: it is the device's work from the span's first operation to its
last. The port runs on one stream. Where the host enters a span while the
device still runs earlier work, the few-microsecond bubbles between those
earlier kernels are taken off too.

Host ms of an instance: its host range, less the time the host waited on the
device inside it (`waits`). Every reading is None off the card and where the
run recorded no such span (a program without spans).
"""
from __future__ import annotations

import re
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

# a CUDA runtime or driver call in the trace (cudaLaunchKernel, cuLaunchKernel)
_CUDA_CALL = re.compile(r"cu(da)?[A-Z]")


def _program():
    """The program's span module, or None where it keeps no span records."""
    try:
        from checkerpose_tpu_torch.utils import logging as plog
    except ImportError:
        return None
    return plog if hasattr(plog, "span_records") else None


def _traced(ctx) -> bool:
    return ctx.device.type == "cuda" and ctx.trace is not None


def host_ranges(ctx, name: str) -> List[Tuple[float, float]]:
    """(start, end) s of the span's host ranges in the traced call, by start."""
    return sorted((s, e) for n, s, e in ctx.trace.host_ops if n == name)


def _starts_inside(ctx, ranges) -> List[bool]:
    lo, hi = ctx.trace.window
    return [lo <= s < hi for s, _ in ranges]


def _window_ranges(ctx, name: str) -> List[Tuple[float, float]]:
    ranges = host_ranges(ctx, name)
    return [r for r, inside in zip(ranges, _starts_inside(ctx, ranges)) if inside]


def count(ctx, name: str) -> int:
    """Instances of the span in the traced window."""
    return len(_window_ranges(ctx, name))


def _union(spans) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _intersect(a, b) -> List[Tuple[float, float]]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    return sum(e - s for s, e in _intersect(a, b))


def gaps(ctx) -> List[Tuple[float, float]]:
    """The traced window's stretches in which no device operation ran."""
    t = ctx.trace
    lo, hi = t.window
    edges = [lo] + [x for iv in t.intervals() for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def device_ms(ctx, name: str) -> Optional[List[float]]:
    """Device ms of each of the span's instances in the traced window: its
    event pair's interval less the idle inside its host range."""
    plog = _program()
    ranges = host_ranges(ctx, name)
    if plog is None or not ranges:
        return None
    records = [r for r in plog.span_records() if r.name == name]
    if len(records) < len(ranges):
        return None
    chosen = [(r, rng) for r, rng, inside in zip(records[-len(ranges):], ranges,
                                                   _starts_inside(ctx, ranges)) if inside]
    values = [r["device_ms"] for r in plog.resolve_spans([r for r, _ in chosen])]
    if not values or None in values:
        return None
    idle = gaps(ctx)
    return [ms - 1e3 * _overlap(idle, [rng]) for ms, (_, rng) in zip(values, chosen)]


def device_ms_per(ctx, names: Sequence[str], per: str) -> Optional[float]:
    """Device ms of the window's instances of `names`, summed, over its
    instances of `per` (one a batch or a step)."""
    if not _traced(ctx):
        return None
    units = count(ctx, per)
    values = [device_ms(ctx, n) for n in names]
    if not units or any(v is None for v in values):
        return None
    return sum(sum(v) for v in values) / units


def waits(ctx) -> List[Tuple[float, float]]:
    """Where the host waited on the device: inside a CUDA call while the
    device ran, the whole of a synchronisation and, of any other call (a
    launch or a copy that finds the queue full or the copy pending), the part
    past the median duration of its name in the traced call."""
    calls = [(n, s, e) for n, s, e in ctx.trace.host_ops if _CUDA_CALL.match(n)]
    durations: Dict[str, List[float]] = {}
    for n, s, e in calls:
        durations.setdefault(n, []).append(e - s)
    median = {n: statistics.median(d) for n, d in durations.items()}
    blocked = _union((s + (0.0 if "Synchronize" in n else median[n]), e)
                     for n, s, e in calls if "Synchronize" in n or e - s > median[n])
    return _intersect(blocked, ctx.trace.intervals())


def host_ms_per(ctx, names: Sequence[str], per: str) -> Optional[float]:
    """Host ms inside the window's instances of `names` (which do not nest)
    less the host's waits on the device there, summed, over its instances of
    `per`."""
    if not _traced(ctx):
        return None
    units = count(ctx, per)
    if not units:
        return None
    inside = _union(r for n in names for r in _window_ranges(ctx, n))
    total = sum(e - s for s, e in inside) - _overlap(waits(ctx), inside)
    return 1e3 * total / units


def idle_share_inside(ctx, name: str) -> Optional[float]:
    """Percent of the traced window in which no device operation ran while
    the host was inside the span."""
    if not _traced(ctx) or not ctx.trace.device_ops:
        return None
    t = ctx.trace
    lo, hi = t.window
    inside = _union((max(s, lo), min(e, hi)) for s, e in host_ranges(ctx, name)
                    if e > lo and s < hi)
    if not inside:
        return None
    return 100.0 * _overlap(gaps(ctx), inside) / t.window_s
