"""Reductions of a torch.profiler trace, and the card's published peaks.

`profiled(fn)` runs `fn` under the profiler; `fn` marks the traced window
with a host range of its own, and the trace is reduced to a `Trace`: every
device operation (kernels, copies, sets) that overlaps the window as
(name, start, end) in seconds, the window, the host ranges, and the count
of units of work that `fn` reports inside the window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, f32 FLOP/s
# outside the tensor cores, HBM3 bytes/s (at the 700 W power limit)
PEAK_BF16_S = 989e12
PEAK_F32_S = 67e12
PEAK_BYTES_S = 3.35e12

WINDOW = "posebench.window"


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    units: int

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> List[Tuple[str, float, float]]:
        """Device operations that are kernels (no memory copy or set)."""
        return [op for op in self.device_ops if not _is_mem(op[0])]

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of device operations inside the window, sorted."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_ops
                       if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals())

    def top_device_ops(self, n: int = 10):
        tot = {}
        for name, s, e in self.device_ops:
            tot[name[:160]] = tot.get(name[:160], 0.0) + (e - s)
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest gaps without a device operation, each named by the
        innermost host range running at its middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            inner = [h for h in self.host_ops if h[1] <= mid <= h[2] and h[0] != WINDOW]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "(no host range)"
            out.append([name[:160], e - s])
        return out


def _is_mem(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


class Window:
    """The traced window: a host range the measured function opens and
    closes itself (after its own warm-up, before its own drain)."""

    def __init__(self, device):
        self.device, self.rf, self.done = device, None, False

    def open(self, sync: bool = True):
        from torch.profiler import record_function
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rf = record_function(WINDOW)
        self.rf.__enter__()

    def close(self, sync: bool = True):
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rf.__exit__(None, None, None)
        self.done = True


def profiled(fn: Callable[[Window], int], device) -> Trace:
    """Run fn(window) under torch.profiler; fn opens and closes the window
    and returns the units of work inside it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    win = Window(device)
    with profile(activities=acts) as prof:
        units = fn(win)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if not win.done:
        raise RuntimeError("the traced function never closed its window")
    dev, host, window = [], [], None
    for e in prof.events():
        span = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        else:
            host.append(span)
            if e.name == WINDOW:
                window = span[1:]
    # a host range (record_function) is mirrored on the device's timeline as
    # an annotation that spans its kernels; it is no device operation
    ranges = {name for name, _, _ in host}
    dev = [op for op in dev if op[0] not in ranges]
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    lo, hi = window
    dev = [op for op in dev if op[2] > lo and op[1] < hi]
    return Trace(dev, host, window, units)


def timed(fn: Callable, name: str, spans: dict, device):
    """fn with the device synchronised before and after each call, its host
    seconds appended to spans[name]."""
    def wrapped(*args, **kwargs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        spans.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    return wrapped


class ModuleEvents:
    """CUDA events at forward pre- and post-hooks of the given modules: the
    device seconds the modules took, summed per `mark()` (one unit of work)."""

    def __init__(self, modules, device):
        self.device, self.pairs, self.units = device, [], []
        self.handles = []
        for m in modules:
            self.handles.append(m.register_forward_pre_hook(self._pre))
            self.handles.append(m.register_forward_hook(self._post))

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _pre(self, module, args):
        if self.device.type == "cuda":
            self.pairs.append([self._event(), None])

    def _post(self, module, args, out):
        if self.device.type == "cuda":
            self.pairs[-1][1] = self._event()

    def mark(self):
        self.units.append(len(self.pairs))

    def close(self) -> Optional[List[float]]:
        """Seconds per unit; None off the card."""
        for h in self.handles:
            h.remove()
        if self.device.type != "cuda" or not self.units:
            return None
        torch.cuda.synchronize(self.device)
        per, at = [], 0
        for end in self.units:
            per.append(sum(a.elapsed_time(b) for a, b in self.pairs[at:end]) / 1e3)
            at = end
        return per
