"""The LM multi-object evaluation through `eval/harness.py::evaluate_pipeline`,
the path of `cli/test_lm.py`: one call a batch, one object's crops a batch,
the objects in turn as test_lm sweeps them, every EdgeConv on the batch's
per-sample graph (rows of the stacked (O, N, K) table).

Batches are host numpy dicts from a seeded in-memory loader: uint8 crops
from a pool, the object's ground-truth poses, boxes, projections, masks and
normalised keypoints. Each call uploads its batch, decodes under every
filter mode, solves them in one stacked call and copies the batch's results
to the host once; the host aggregates.

Traffic keys: batch, pool_batches, filter_modes, main_filter, warm_calls,
span_calls, trace_warm, trace_calls.
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
    per_sample_graph = True
    channels = (0, 1)

    def __init__(self, ctx):
        self.ctx, self.t = ctx, ctx.cell.traffic
        self.modes = tuple(self.t["filter_modes"])
        self.rate, self.calls = None, 0

    def setup(self):
        import checkerpose_tpu_torch.eval.harness as harness
        from checkerpose_tpu_torch.cli.common import solver_kwargs
        from checkerpose_tpu_torch.models.posenet import knn_tensor
        ctx, t, dev = self.ctx, self.t, self.ctx.device
        cfg = ctx.cell.config
        self.harness = harness
        self.solver_kw = solver_kwargs({})
        self.state = common.state_for(ctx)
        self.net = common.program_net(cfg, self.state, dev)
        self.p3d, p3dn, knn = common.keypoint_sets(ctx)
        self.knn = knn_tensor(knn, cfg["model"]["npoint"], dev)
        self.diam = [float(np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1)).max())
                     for p in self.p3d]
        B, P, O = t["batch"], t["pool_batches"], cfg["objects"]
        crops = inputs.device_crops(inputs.torch_seed(ctx.seed, common.SEED_CROPS), B * P, dev)
        self.pool = list(crops.cpu().numpy().reshape(P, B, 256, 256, 3))
        del crops
        rng = inputs.rng_for(ctx.seed, common.SEED_POSES)
        self.batches = []
        for o in range(O):
            R, tt, uv, bbox = inputs.random_poses(rng, B, self.p3d[o])
            self.batches.append({
                "image": self.pool[o % P], "obj_idx": np.full(B, o, np.int32), "R": R,
                "t": tt, "bbox": bbox, "cam_K": np.broadcast_to(
                    inputs.CAM_K.astype(np.float32), (B, 3, 3)).copy(),
                "proj_xy": uv, "mask_visib": inputs.masks(rng, B)["mask_visib"],
                "valid": np.ones(B, np.float32), "n_real": B,
                "scene_id": np.zeros(B, np.int32), "im_id": np.arange(B, dtype=np.int32),
                "p3d_normed": np.broadcast_to(p3dn[o], (B, *p3dn[o].shape)).copy()})
        self.solver_seed = inputs.torch_seed(ctx.seed, common.SEED_SOLVER)
        lim = ctx.cell.limits["sample"]
        self.cap = capture.Capture(inputs.rng_for(ctx.seed, common.SEED_SAMPLE), lim["batches"])
        self.hook = self.net.register_forward_hook(self.cap.forward_hook)
        self.solver = harness.solve_poses_batched
        self.wrapped = harness.solve_poses_batched = self.cap.wrap_solver(self.solver)
        for _ in range(t["warm_calls"]):
            self._call()
        common.sync(dev)

    def _call(self, spans=None):
        """One evaluate_pipeline call over the next object's batch."""
        o = self.calls % len(self.batches)
        b = self.batches[o]
        B = b["image"].shape[0]
        self.cap.meta = {"images": torch.from_numpy(b["image"]),
                         "bbox": torch.from_numpy(b["bbox"]),
                         "knn": self.knn[o].expand(B, *self.knn.shape[1:])}
        cfg = self.ctx.cell.config
        rep = self.harness.evaluate_pipeline(
            self.net, self.knn, [b], self.p3d[o], self.diam[o],
            stage=cfg["model"]["res_log2"] - 3, use_adi=o in cfg["symmetric_objects"],
            filter_modes=self.modes, main_filter=self.t["main_filter"],
            seed=self.solver_seed + self.calls, spans=spans, **self.solver_kw)
        self.calls += 1
        return rep["n_images"]

    def window(self, seconds):
        self.cap.on = True
        t0 = time.perf_counter()
        done = 0
        while time.perf_counter() - t0 < seconds:
            done += self._call()
        elapsed = time.perf_counter() - t0
        self.cap.on = False
        self.rate = done / elapsed
        return {"crops_per_s": self.rate}, done, 0

    def instrumented(self):
        ctx, dev = self.ctx, self.ctx.device
        events = tr.ModuleEvents(common.edgeconvs(self.net), dev)
        spans, before = {}, common.launches(ctx)
        n = self.t["span_calls"]
        for _ in range(n):
            self._call(spans)
            events.mark()
        after = common.launches(ctx)
        ctx.counters["edgeconv_launches_per_batch"] = {k: (after[k] - before[k]) / n
                                                       for k in after}
        ctx.spans["forward"] = spans["forward_decode"]
        ctx.spans["solver"] = spans["solver_metrics"]
        ctx.spans["edgeconv"] = events.close()

    def one_unit(self, win):
        win.open()
        self._call()
        win.close()
        return 1

    def traced_units(self, win):
        for _ in range(self.t["trace_warm"]):
            self._call()
        win.open()
        for _ in range(self.t["trace_calls"]):
            self._call()
        win.close()
        return self.t["trace_calls"]

    def check(self):
        ctx, dev = self.ctx, self.ctx.device
        self.hook.remove()
        if self.harness.solve_poses_batched is self.wrapped:
            self.harness.solve_poses_batched = self.solver
        del self.net
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
