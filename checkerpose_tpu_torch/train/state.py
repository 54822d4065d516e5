"""Train state: module + optimizer, with factories per model (counterpart
of checkerpose_tpu/train/state.py).

The parameters and BatchNorm statistics live in the module and the Adam
moments in the optimizer, both updated in place by a step, so the state holds
the two objects and the two scalars that a checkpoint carries beside them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional

import torch
import torch.nn as nn

from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.models.layers import init_params
from checkerpose_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class TrainState:
    """`mesh`: the data-parallel mesh the module is replicated over
    (parallel/mesh.py; `train/loop.py::run_training` sets it), which the
    steps read; None for one process."""
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    best_score: float = -1.0
    mesh: Optional[Mesh] = None

    def variables(self) -> dict:
        """{"params", "batch_stats"}: the module's parameters and its
        BatchNorm running statistics by name (Flax's two collections; the
        tensors themselves, not copies)."""
        return {"params": dict(self.module.named_parameters()),
                "batch_stats": dict(self.module.named_buffers())}


class TwoPhaseAdam(torch.optim.Adam):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) whose rate is `lr` for the first
    `lr2_start` updates and `lr2` from update number `lr2_start` (counted
    from 0) on: the rule of `optax.join_schedules` with two constant
    schedules. The count of updates made is kept in each param group
    (`count`), so `state_dict()` carries it."""

    def __init__(self, params, lr: float, lr2: float, lr2_start: int):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for group in self.param_groups:
            group.update(lr1=lr, lr2=lr2, lr2_start=int(lr2_start), count=0)

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = group["lr1"] if group["count"] < group["lr2_start"] else group["lr2"]
        loss = super().step(closure)
        for group in self.param_groups:
            group["count"] += 1
        return loss


def make_optimizer(learning_rate: float, lr2: Optional[float] = None,
                   lr2_start: Optional[int] = None
                   ) -> Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]:
    """The optimizer of the configs as a factory over parameters (a torch
    optimizer is bound to its parameters; `create_*_state` calls this with
    the module's): Adam at `learning_rate`, or the two-phase rate when both
    `lr2` and `lr2_start` are given."""
    if lr2 is not None and lr2_start is not None:
        return lambda params: TwoPhaseAdam(params, learning_rate, lr2, lr2_start)
    return lambda params: torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                           eps=1e-8)


def _create_state(net, optimizer, seed, device) -> TrainState:
    dev = resolve_device(device)
    if seed is not None:
        init_params(net, torch.Generator().manual_seed(seed))
    net.to(dev).train()
    return TrainState(module=net, optimizer=optimizer(net.parameters()))


def create_init_state(net, optimizer, *, seed: Optional[int] = 0,
                      device="cuda") -> TrainState:
    """An InitNet ready to pretrain on `device`, in train mode. `optimizer`
    is `make_optimizer(...)`. The parameters are re-drawn from `seed` with
    the Flax initialisers; `seed=None` keeps the module's own."""
    return _create_state(net, optimizer, seed, device)


def create_pose_state(net, optimizer, *, seed: Optional[int] = 0, init_params=None,
                      device="cuda") -> TrainState:
    """A PoseNet ready to train on `device`, in train mode. init_params:
    optional pretrained InitNet state_dict (or a {"model": state_dict}
    checkpoint payload) grafted into `net.init_net`, parameters and BatchNorm
    statistics alike (the non-strict pretrain -> train handoff)."""
    state = _create_state(net, optimizer, seed, device)
    if init_params is not None:
        graft_init_params(net, init_params)
    return state


def graft_init_params(pose_net, init_bundle: Mapping):
    """Copy a pretrained InitNet's entries into `pose_net.init_net`: entries
    present on both sides with the same shape are overwritten in place, the
    others are reported (non-strict, and says what it did)."""
    sd = init_bundle["model"] if "model" in init_bundle else init_bundle
    own = pose_net.init_net.state_dict()
    loaded, skipped = [], []
    with torch.no_grad():
        for k, v in sd.items():
            if k in own and own[k].shape == v.shape:
                own[k].copy_(v)
                loaded.append(k)
            else:
                skipped.append(k)
    kept = sorted(set(own) - set(loaded))
    if skipped:
        print(f"graft_init_params: unexpected entries not grafted: {skipped}")
    if kept:
        print(f"graft_init_params: init_net entries left as they were: {kept}")
    print(f"graft_init_params: loaded {len(loaded)} entries into init_net")
    return pose_net


def param_count(module: nn.Module) -> float:
    """Parameters of `module` in millions (BatchNorm statistics not counted)."""
    return sum(p.numel() for p in module.parameters()) / 1e6
