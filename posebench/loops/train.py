"""Training through `train/steps.py::make_train_step` at the configuration's
recipe (Adam, the curriculum stage, the colour augmentation with salt and
pepper and motion blur), on a device-resident pool of seeded synthetic
batches: uint8 crops, the keypoints' projections under random poses, their
boxes, random visible and full masks. The host loader is not in this cell.
A configuration of one object trains on its static (N, K) graph; one of
more on the stacked (O, N, K) table, each sample's object drawn uniformly
from the seed (`obj_idx`), so that every EdgeConv runs on the batch's
per-sample (B, N, K) graph (`train/steps.py::knn_for_batch`), as
`train_lm.py` trains on mixed-object batches.

Set-up builds the one train state the window uses and drives it through
its first steps on batches that all differ; the reference follows the
first `checked_steps` of them afterwards (see `check`), its refine stages
gathering at the cells the program's gathered at (its decisions), so that
a near-tie decided the other way does not send the two down different
paths.

Traffic keys: batch, pool_batches, warm_steps (set-up, the checked steps
included), checked_steps, span_steps, trace_warm, trace_steps, and
optionally rate_metric: the end-to-end metric the window's images/s is
reported as (default `train_images_per_s`), so that a cell can be held to
a bound of its own.
"""
from __future__ import annotations

import statistics
import time

import torch

from posebench import capture, inputs
from posebench import trace as tr
from posebench.loops import common
from posebench.reference import model as ref
from posebench.reference import train as ref_train


CHANNELS = (0, 1)                     # both seg channels enter the loss


def _norms(tensors):
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog, refn, keep=None):
    """{leaf: |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's}."""
    names = [k for k in refn if keep is None or k in keep]
    med = statistics.median(refn[k] for k in names)
    return {k: abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30) for k in names}


class Loop:
    training = True

    def __init__(self, ctx):
        self.ctx, self.t = ctx, ctx.cell.traffic
        self.rate, self.steps = None, 0
        self.per_sample_graph = ctx.cell.config["objects"] > 1

    def setup(self):
        from checkerpose_tpu_torch.train.state import create_pose_state, make_optimizer
        from checkerpose_tpu_torch.train.steps import make_train_step
        ctx, t, dev = self.ctx, self.t, self.ctx.device
        cfg, tc = ctx.cell.config, ctx.cell.config["train"]
        self.state0 = common.state_for(ctx)
        net = common.program_net(cfg, self.state0, dev)
        p3d, p3dn, knn = common.keypoint_sets(ctx)
        self.knn = torch.as_tensor(knn if self.per_sample_graph else knn[0], device=dev)
        self.train_state = create_pose_state(net, make_optimizer(tc["learning_rate"]),
                                             seed=None, device=dev)
        self.step_fn = make_train_step(net, self.knn, tc["stage"],
                                       use_pepper_salt=tc["use_pepper_salt"],
                                       use_motion_blur=tc["use_motion_blur"])
        B, P = t["batch"], t["pool_batches"]
        crops = inputs.device_crops(inputs.torch_seed(ctx.seed, common.SEED_CROPS), B * P, dev)
        rng = inputs.rng_for(ctx.seed, common.SEED_POSES)
        obj_rng = inputs.rng_for(ctx.seed, common.SEED_OBJECTS)
        self.pool = []
        for i in range(P):
            obj = obj_rng.integers(0, len(p3d), B) if self.per_sample_graph else None
            rows = 0 if obj is None else obj
            _, _, uv, bbox = inputs.random_poses(rng, B, p3d[rows])
            m = inputs.masks(rng, B)
            batch = {
                "image": crops[i * B:(i + 1) * B], "proj_xy": torch.as_tensor(uv, device=dev),
                "bbox": torch.as_tensor(bbox, device=dev),
                "mask_visib": torch.as_tensor(m["mask_visib"], device=dev),
                "mask_full": torch.as_tensor(m["mask_full"], device=dev),
                "p3d_normed": torch.as_tensor(p3dn[rows], device=dev).expand(B, -1, -1)}
            if obj is not None:
                batch["obj_idx"] = torch.as_tensor(obj, device=dev)
            self.pool.append(batch)
        self.aug_seed = inputs.torch_seed(ctx.seed, common.SEED_STEPS)
        self.gen = torch.Generator(device=dev).manual_seed(self.aug_seed)
        # the checked steps: the window's own call and feed, on distinct batches
        n_chk = t["checked_steps"]
        if n_chk > P:
            raise ValueError("the checked steps need a batch each")
        self.losses, self.served = [], []
        params = dict(net.named_parameters())
        opt = self.train_state.optimizer
        hook = net.register_forward_hook(self._served)
        for i in range(n_chk):
            self.losses.append(float(self._step()["loss"]))
            if i == 0:
                # Adam's first moment after one step is (1 - 0.9) x the gradient
                self.grad1 = _norms({k: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                                     / 0.1 for k, p in params.items()})
        hook.remove()
        self.change = _norms({k: p.detach() - self.state0[k] for k, p in params.items()})
        for _ in range(t["warm_steps"] - n_chk):
            self._step()
        common.sync(dev)

    def _served(self, module, args, out):
        """The program's outputs of a checked step's forward: the cells its
        refine stages gathered at, its RoI bits and its logits."""
        self.served.append({k: out[k].detach() for k in
                            ("x_id", "y_id", "roi_logit", "x_logits", "y_logits", "seg_logits")})
        self.served[-1]["roi"] = out["roi_logit"].detach()[..., 0] > 0

    def graph(self, i):
        """The reference's graph of pool batch i: the static graph, or each
        sample's rows of the table."""
        if not self.per_sample_graph:
            return self.knn
        return self.knn[self.pool[i]["obj_idx"]]

    def _step(self):
        batch = self.pool[self.steps % len(self.pool)]
        self.steps += 1
        return self.step_fn(self.train_state, batch, self.gen)

    def window(self, seconds):
        dev = self.ctx.device
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._step()
            n += 1
        common.sync(dev)
        elapsed = time.perf_counter() - t0
        images = n * self.t["batch"]
        self.rate = images / elapsed
        return {self.t.get("rate_metric", "train_images_per_s"): self.rate}, images, 0

    def instrumented(self):
        ctx, dev = self.ctx, self.ctx.device
        step = tr.timed(self._step, "step", ctx.spans, dev)
        for _ in range(self.t["span_steps"]):
            step()

    def one_unit(self, win):
        win.open()
        self._step()
        win.close()
        return 1

    def traced_units(self, win):
        for _ in range(self.t["trace_warm"]):
            self._step()
        win.open()
        for _ in range(self.t["trace_steps"]):
            self._step()
        win.close()
        return self.t["trace_steps"]

    def _forced(self, i):
        """The program's cells of checked step i, where it served the step's
        whole batch (else None: the reference decides its own)."""
        s = self.served[i]
        if len(s["x_id"]) != len(self.pool[i]["image"]):
            return None
        return {"x_id": s["x_id"], "y_id": s["y_id"], "roi": s["roi"]}

    def _trainer(self, quant):
        ctx, dev = self.ctx, self.ctx.device
        cfg, tc = ctx.cell.config, ctx.cell.config["train"]
        net = common.reference_net(cfg, self.state0, dev)
        ref.set_quant(net, quant)
        gen = torch.Generator(device=dev).manual_seed(self.aug_seed)
        return ref_train.Trainer(net, tc["learning_rate"], gen, tc["stage"],
                                 tc["use_pepper_salt"], tc["use_motion_blur"])

    def _reference(self, quant=None, served=None):
        """The reference's first checked steps from the same weights, batches
        and draws, gathering at `served`'s cells (the program's by default;
        a list holding None lets it decide): (losses, first-gradient norms,
        change norms, step 1's outputs)."""
        if served is None:
            served = [self._forced(i) for i in range(self.t["checked_steps"])]
        tr_ = self._trainer(quant)
        losses, grad1, out1 = [], None, None
        for i in range(self.t["checked_steps"]):
            losses.append(tr_.step(self.pool[i], self.graph(i), forced=served[i]))
            if i == 0:
                grad1, out1 = _norms(tr_.grads()), tr_.out
        change = _norms({k: p.detach() - self.state0[k] for k, p in tr_.net.named_parameters()})
        del tr_
        common.free(self.ctx.device)
        return losses, grad1, change, out1

    def _step1_outputs(self, forced, quant):
        """The reference's outputs of step 1's forward, gathering at `forced`."""
        tr_ = self._trainer(quant)
        out = tr_.forward(self.pool[0], self.graph(0), forced=forced)
        del tr_
        common.free(self.ctx.device)
        return out

    def _judge(self, served, forced, ref32_out):
        """Step 1's forward: the served bits and logits against the float32
        reference's and the bfloat16 reference's (capture.BitJudge)."""
        if forced is None:                    # the program served other rows
            return {k: float("inf") for k in ("logit_err_ratio", "logit_err_p50_ratio",
                                              "bit_flip_ratio", "bit_gap_ratio")}
        judge = capture.BitJudge()
        every = torch.arange(len(forced["x_id"]), device=forced["x_id"].device)
        ref16_out = self._step1_outputs(forced, "bf16")
        cells = {"x_id": served["x_id"], "y_id": served["y_id"]}      # seg read there
        judge.add(*capture.served(served, every, CHANNELS),
                  *(capture.served(dict(o, **cells), every, CHANNELS)[1]
                    for o in (ref32_out, ref16_out)))
        return judge.numbers()

    def _numbers(self, losses, grad1, change, ref_run):
        r_losses, r_grad, r_change, _ = ref_run
        med = statistics.median(r_grad.values())
        moved = sorted(k for k, v in r_grad.items() if v >= 1e-3 * med)
        g, c = leaf_gaps(grad1, r_grad), leaf_gaps(change, r_change, moved)
        self.diag = {"grad_worst": max(g, key=g.get), "change_worst": max(c, key=c.get)}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
                "grad_norm_gap": max(g.values()),
                "grad_norm_gap_median": statistics.median(g.values()),
                "change_norm_gap": max(c.values()),
                "change_norm_gap_median": statistics.median(c.values()),
                "leaves_left_out": float(len(r_grad) - len(moved))}

    def check(self):
        ctx, dev = self.ctx, self.ctx.device
        del self.train_state, self.step_fn
        common.free(dev)
        self.ref_run = self._reference()
        nums = self._numbers(self.losses, self.grad1, self.change, self.ref_run)
        nums.update(self._judge(self.served[0], self._forced(0), self.ref_run[3]))
        self.numbers = nums
        lim = ctx.cell.limits["limits"]
        return [(k, nums[k], lim[k]) for k in lim]

    def control(self):
        """The control: the reference with float8 products trained in the
        program's place (its own decisions), judged as the program is."""
        steps = self.t["checked_steps"]
        losses, grad1, change, out1 = self._reference("fp8", served=[None] * steps)
        forced = {"x_id": out1["x_id"], "y_id": out1["y_id"], "roi": out1["roi_logit"] > 0}
        nums = self._numbers(losses, grad1, change, self.ref_run)
        nums.update(self._judge(out1, forced, self._step1_outputs(forced, None)))
        return nums

    def close(self):
        self.pool = None
        common.free(self.ctx.device)
