"""Faults planted underneath the timed path, for the tests that show a
comparison failing. Each is a context manager that patches the measured
program where the fault would arise and restores it on exit; install it
before the loop's set-up, so that the harness wraps the faulty entry.

* altered_pose: the solver's answers are turned by 10 degrees about the
  camera's axis;
* altered_bit: the most significant x bit of the first keypoint of every
  crop is flipped where the network produces its ids;
* half_batch: the network computes the first half of the batch and gives
  its outputs for the second half too; in training the loss is the mean
  over the first half alone;
* unchanged: a training step computes its loss and gradients but leaves
  the parameters and the optimizer's state as they were;
* other_objects: on a stacked (O, N, K) graph table, each sample's
  EdgeConvs gather on the next object's rows (object o on o + 1 mod O)
  instead of its own.
"""
from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _turn(out):
    c, s = math.cos(math.radians(10.0)), math.sin(math.radians(10.0))
    Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], device=out["R"].device)
    return dict(out, R=Rz @ out["R"])


def altered_pose():
    import checkerpose_tpu_torch.eval.harness as harness
    import checkerpose_tpu_torch.serving as serving
    stack = contextlib.ExitStack()
    for mod, name in ((serving, "ransac_pnp"), (harness, "solve_poses_batched")):
        stack.enter_context(_patched(mod, name, lambda f: lambda *a, **k: _turn(f(*a, **k))))
    return stack


def altered_bit():
    from checkerpose_tpu_torch.models.posenet import PoseNet

    def make(forward):
        def wrapped(self, *args, **kwargs):
            out = forward(self, *args, **kwargs)
            if self.training:
                return out
            x = out["x_id"].clone()
            top = 1 << (out["x_logits"].shape[-1] - 1)
            x[:, 0] = x[:, 0] ^ top
            return dict(out, x_id=x)
        return wrapped
    return _patched(PoseNet, "forward", make)


def half_batch():
    from checkerpose_tpu_torch.models.posenet import PoseNet
    from checkerpose_tpu_torch.train import steps

    def make_forward(forward):
        def wrapped(self, img, knn, *args, **kwargs):
            if self.training:
                return forward(self, img, knn, *args, **kwargs)
            B = img.shape[0]
            h = max(B // 2, 1)
            kn = knn[:h] if knn.dim() == 3 else knn
            args = tuple(a[:h] if torch.is_tensor(a) and a.shape[:1] == (B,) else a
                         for a in args)
            out = forward(self, img[:h], kn, *args, **kwargs)
            idx = torch.arange(B, device=img.device) % h
            return {k: v[idx] for k, v in out.items()}
        return wrapped

    def make_loss(loss):
        def wrapped(net, knn, imgs, batch, *args, **kwargs):
            h = max(imgs.shape[0] // 2, 1)
            half = {k: (v[:h] if torch.is_tensor(v) and v.shape[:1] == imgs.shape[:1] else v)
                    for k, v in batch.items()}
            return loss(net, knn, imgs[:h], half, *args, **kwargs)
        return wrapped
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(PoseNet, "forward", make_forward))
    stack.enter_context(_patched(steps, "train_loss", make_loss))
    return stack


def unchanged():
    from checkerpose_tpu_torch.train import steps

    def make(update):
        def wrapped(state, total):
            state.optimizer.zero_grad(set_to_none=False)
            total.backward()
            state.step += 1
        return wrapped
    return _patched(steps, "_update", make)


def other_objects():
    from checkerpose_tpu_torch.train import steps

    def make(knn_for_batch):
        def wrapped(knn_idx, batch):
            if knn_idx.dim() == 3:
                batch = dict(batch, obj_idx=(batch["obj_idx"] + 1) % knn_idx.shape[0])
            return knn_for_batch(knn_idx, batch)
        return wrapped
    return _patched(steps, "knn_for_batch", make)


FAULTS = {"altered_pose": altered_pose, "altered_bit": altered_bit,
          "half_batch": half_batch, "unchanged": unchanged, "other_objects": other_objects}
