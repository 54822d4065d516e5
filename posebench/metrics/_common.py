"""Reductions the per-layer metric readers share. A reader returns None
where its cell's run gave it nothing to read; shares are in percent."""
from __future__ import annotations

import statistics

from posebench import trace as tr


def mean_ms(ctx, span):
    values = ctx.spans.get(span)
    return 1e3 * statistics.fmean(values) if values else None


def idle_share(ctx):
    t = ctx.trace
    if t is None or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(ctx):
    if not ctx.rate or not ctx.flops_per_item or ctx.device.type != "cuda":
        return None
    return 100.0 * ctx.flops_per_item * ctx.rate / tr.PEAK_BF16_S


def peak_gib(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2 ** 30


def launches_per_unit(ctx):
    t = ctx.launch_trace
    if t is None or not t.device_ops or not t.units:
        return None
    return len(t.kernels()) / t.units
