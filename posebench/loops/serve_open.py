"""Open-loop serving through `ServingPipeline.__call__`: requests arrive on a
schedule whatever the system does, and each is timed from its due time to
its poses on the host.

A request is a frame's detections of one part: 1 to 8 crops, each from the
device pool with its own box. Arrivals are Poisson at `mean_crops_per_s`
(over the mean request size), modulated in bursts: `burst_factor` times
the mean rate for `burst_s` seconds in every `period_s`, and the rate that
keeps the mean the rest of the time. Every seed gets the same request
sizes and the same inter-arrival gaps (the exponential's quantiles), in
its own order, so that runs differ in order and not in amount of work.

The batcher takes every due request, whole, when the previous call has
returned, up to `max_batch` crops, and pads the batch to the next of
`shapes` (copies of its first crop, neither counted nor judged); every
shape is warmed at set-up.

Traffic keys: mean_crops_per_s, min_crops, max_crops, burst_factor,
burst_s, period_s, shapes, max_batch, drain_s, pool_batches, batch (the
pool's batch), warm_batches, span_batches, trace_warm_s, trace_s.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from posebench import inputs
from posebench.loops import common, serve_stream


def schedule(rng: np.random.Generator, t: dict, seconds: float):
    """(due times (R,) s from the window's start, sizes (R,)) of the requests
    due in [0, seconds)."""
    lo, hi = t["min_crops"], t["max_crops"]
    mean_size = 0.5 * (lo + hi)
    n = int(np.ceil(t["mean_crops_per_s"] / mean_size * seconds * 1.5)) + 8
    sizes = np.resize(np.arange(lo, hi + 1), n)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)           # quantiles of Exp(1)
    rng.shuffle(sizes)
    rng.shuffle(gaps)
    op = np.cumsum(gaps) / (t["mean_crops_per_s"] / mean_size)   # at the mean rate
    # warp to real time: the rate is burst_factor x the mean in the first
    # burst_s of each period and `low` x the mean in the rest
    P, b, f = t["period_s"], t["burst_s"], t["burst_factor"]
    low = (P - f * b) / (P - b)
    grid = np.linspace(0.0, seconds * 2, int(seconds * 2 * 1000) + 1)
    mult = np.where((grid % P) < b, f, low)
    cum = np.concatenate([[0.0], np.cumsum(0.5 * (mult[1:] + mult[:-1]) * np.diff(grid))])
    due = np.interp(op, cum, grid)
    keep = due < seconds
    return due[keep], sizes[keep]


class Loop(serve_stream.Loop):

    def setup(self):
        super().setup()
        t, dev = self.t, self.ctx.device
        self.flat = self.pool.view(-1, 256, 256, 3)
        self.flat_bbox = self.bbox.view(-1, 4)
        for shape in t["shapes"]:
            for _ in range(2):
                self._serve(torch.arange(shape, device=dev) % self.flat.shape[0])
        common.sync(dev)
        self.rng = inputs.rng_for(self.ctx.seed, common.SEED_ARRIVALS)

    def _serve(self, idx, real=None):
        """One synchronous call on the crops `idx`, of which the first `real`
        are requests' (the rest padding); poses on the host."""
        imgs, bbox = self.flat[idx], self.flat_bbox[idx]
        self.cap.meta = {"images": imgs, "bbox": bbox, "knn": self.knn,
                         "real": len(idx) if real is None else real}
        out = self.pipe(imgs, bbox, self.K, self.gen)
        return out["R"].cpu(), out["t"].cpu()

    def _open_loop(self, seconds, on_call=None):
        """Serve one schedule; returns (latencies, waits, real crops a call,
        requests due, crops served, seconds)."""
        t, dev = self.t, self.ctx.device
        due, sizes = schedule(self.rng, t, seconds)
        n_pool = self.flat.shape[0]
        first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        lat, waits, per_call = np.full(len(due), np.nan), [], []
        nxt, served = 0, 0
        t0 = time.perf_counter()
        while nxt < len(due):
            now = time.perf_counter() - t0
            if now > seconds + t["drain_s"]:
                break
            if due[nxt] > now:
                time.sleep(min(due[nxt] - now, 0.05))
                continue
            take, crops = nxt, 0
            while take < len(due) and due[take] <= now and crops + sizes[take] <= t["max_batch"]:
                crops += int(sizes[take])
                take += 1
            shape = next(s for s in t["shapes"] if s >= crops)
            ids = np.concatenate([np.arange(first[r], first[r] + sizes[r]) for r in
                                  range(nxt, take)])
            ids = np.concatenate([ids, np.full(shape - crops, ids[0])]) % n_pool
            start = time.perf_counter() - t0
            if on_call is not None:
                on_call(start)
            self._serve(torch.as_tensor(ids, device=dev), crops)
            end = time.perf_counter() - t0
            lat[nxt:take] = end - due[nxt:take]
            waits.extend(start - due[nxt:take])
            per_call.append(crops)
            served += crops
            nxt = take
        elapsed = time.perf_counter() - t0
        return lat, waits, per_call, len(due), served, elapsed

    def window(self, seconds):
        self.cap.on = True
        lat, waits, per_call, n, served, elapsed = self._open_loop(seconds)
        self.cap.on = False
        self.rate = served / elapsed
        self.ctx.spans["queue_wait"] = list(waits)
        self.ctx.counters["batch_crops"] = per_call
        done = lat[np.isfinite(lat)]
        failed = n - len(done)
        # a request never served counts as missing every limit
        p95 = common.percentile(np.where(np.isfinite(lat), lat, np.inf), 95) * 1e3
        return {"request_p95_ms": p95}, n, failed

    def traced_units(self, win):
        t = self.t
        calls = [0]
        state = {"open": False}

        def on_call(start):
            if not state["open"] and start >= t["trace_warm_s"]:
                win.open(sync=False)
                state["open"] = True
                calls[0] += 1
            elif state["open"] and not win.done and start >= t["trace_warm_s"] + t["trace_s"]:
                win.close(sync=False)
            elif state["open"] and not win.done:
                calls[0] += 1
        self._open_loop(t["trace_warm_s"] + t["trace_s"] + 1.0, on_call)
        if not win.done:
            win.close()
        return calls[0]
