"""Closed-loop serving through `ServingPipeline.stream`: batches of
device-resident uint8 crops from a pool made from the seed, each with its
own boxes, keep `depth` batches queued; the next batch goes in when the
oldest one's poses are on the host.

Traffic keys: batch, pool_batches, depth, warm_batches (set-up), and for
the traced run span_batches (synchronised spans) and trace_warm /
trace_batches (the profiled stretch of a running stream).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from posebench import capture, inputs
from posebench import trace as tr
from posebench.loops import common


class Loop:
    training = False
    per_sample_graph = False
    modes = ("visib",)
    channels = (0,)

    def __init__(self, ctx):
        self.ctx, self.t = ctx, ctx.cell.traffic
        self.rate = None

    def setup(self):
        import checkerpose_tpu_torch.serving as serving
        ctx, t, dev = self.ctx, self.t, self.ctx.device
        self.serving = serving
        self.state = common.state_for(ctx)
        net = common.program_net(ctx.cell.config, self.state, dev)
        p3d, p3dn, knn = common.keypoint_sets(ctx)
        self.p3d, self.knn = p3d[0], torch.as_tensor(knn[0], device=dev)
        self.pipe = serving.ServingPipeline(net, knn[0], p3d[0], p3dn[0], device=dev)
        B, P = t["batch"], t["pool_batches"]
        self.pool = inputs.device_crops(inputs.torch_seed(ctx.seed, common.SEED_CROPS),
                                        B * P, dev).view(P, B, 256, 256, 3)
        rng = inputs.rng_for(ctx.seed, common.SEED_POSES)
        self.bbox = torch.as_tensor(
            np.stack([inputs.random_poses(rng, B, p3d[0])[3] for _ in range(P)]), device=dev)
        self.K = torch.as_tensor(inputs.CAM_K, dtype=torch.float32, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(
            inputs.torch_seed(ctx.seed, common.SEED_SOLVER))
        lim = ctx.cell.limits["sample"]
        self.cap = capture.Capture(inputs.rng_for(ctx.seed, common.SEED_SAMPLE), lim["batches"])
        self.hook = self.pipe.net.register_forward_hook(self.cap.forward_hook)
        self.solver = serving.ransac_pnp
        self.wrapped = serving.ransac_pnp = self.cap.wrap_solver(self.solver)
        self._stream(t["warm_batches"])
        common.sync(dev)

    def _batches(self, n=None, until=None):
        i = 0
        while (n is None or i < n) and (until is None or time.perf_counter() < until):
            j = i % self.t["pool_batches"]
            self.cap.meta = {"images": self.pool[j], "bbox": self.bbox[j], "knn": self.knn}
            yield self.pool[j], self.bbox[j], self.K
            i += 1

    def _stream(self, n=None, until=None, on_yield=None):
        done = 0
        for i, out in enumerate(self.pipe.stream(self._batches(n, until), self.gen,
                                                 depth=self.t["depth"])):
            done += out["R"].shape[0]
            if on_yield is not None:
                on_yield(i)
        return done

    def window(self, seconds):
        self.cap.on = True
        t0 = time.perf_counter()
        done = self._stream(until=t0 + seconds)
        elapsed = time.perf_counter() - t0
        self.cap.on = False
        self.rate = done / elapsed
        return {"crops_per_s": self.rate}, done, 0

    def instrumented(self):
        ctx, dev, pipe = self.ctx, self.ctx.device, self.pipe
        corr, solver = pipe.correspondences, self.serving.ransac_pnp
        pipe.correspondences = tr.timed(corr, "forward", ctx.spans, dev)
        self.serving.ransac_pnp = tr.timed(solver, "solver", ctx.spans, dev)
        events = tr.ModuleEvents(common.edgeconvs(pipe.net), dev)
        before = common.launches(ctx)
        n = self.t["span_batches"]
        for j in range(n):
            pipe(self.pool[j % self.t["pool_batches"]], self.bbox[0], self.K, self.gen)
            events.mark()
        after = common.launches(ctx)
        ctx.counters["edgeconv_launches_per_batch"] = {k: (after[k] - before[k]) / n
                                                       for k in after}
        ctx.spans["edgeconv"] = events.close()
        del pipe.correspondences
        self.serving.ransac_pnp = solver
        B = self.t["batch"]
        ctx.counters["edgeconv_shapes"] = [(B, m.conv.weight.shape[1] // 2,
                                            m.conv.weight.shape[0])
                                           for m in common.edgeconvs(pipe.net)]
        ctx.counters["npoint"], ctx.counters["knn_k"] = self.knn.shape

    def one_unit(self, win):
        win.open()
        out = self.pipe(self.pool[0], self.bbox[0], self.K, self.gen)
        {k: v.cpu() for k, v in out.items()}
        win.close()
        return 1

    def traced_units(self, win):
        warm, n = self.t["trace_warm"], self.t["trace_batches"]

        def on_yield(i):
            if i == warm - 1:
                win.open(sync=False)
            elif i == warm + n - 1:
                win.close(sync=False)
        self._stream(warm + n + self.t["depth"], on_yield=on_yield)
        return n

    def check(self):
        ctx, dev = self.ctx, self.ctx.device
        self.hook.remove()
        if self.serving.ransac_pnp is self.wrapped:
            self.serving.ransac_pnp = self.solver
        del self.pipe
        common.free(dev)
        self.refnet = refnet = common.reference_net(ctx.cell.config, self.state, dev)
        lim = ctx.cell.limits
        nums = capture.inference_numbers(
            self.cap.records(), refnet, inputs.normalize_image, lim["sample"]["rows"],
            inputs.rng_for(ctx.seed, common.SEED_SAMPLE, 1), lim["sample"]["block"],
            self.channels, self.modes)
        self.numbers = nums
        return [(k, nums[k], lim["limits"][k]) for k in lim["limits"]]

    def control(self):
        """The control's numbers on the kept batches (after `check`)."""
        lim = self.ctx.cell.limits["sample"]
        return capture.control_numbers(
            self.cap.records(), self.refnet, inputs.normalize_image, lim["rows"],
            inputs.rng_for(self.ctx.seed, common.SEED_SAMPLE, 1), lim["block"], self.channels)

    def close(self):
        self.cap.kept.clear()
        self.refnet = None
        common.free(self.ctx.device)
