"""Seeded weights, made by the benchmark on the device and loaded into both
the measured program and the reference (a `state_dict` of float32 tensors).

One uniform draw from a `torch.Generator` on the device covers every entry;
each entry is a slice of it, transformed:

* conv, transposed-conv and dense kernels: Flax's lecun normal (a unit
  normal truncated at +-2, variance 1 / fan-in) by the inverse CDF;
* biases: uniform in +-0.05;
* BatchNorm: scale in [0.8, 1.2], bias and running mean in +-0.1, running
  variance in [0.8, 1.25], so that folding a BatchNorm into a kernel is
  exercised by every layer (Flax's identity statistics would hide a fold
  that drops the mean or the variance);
* the last BatchNorm of every residual branch (a basic block's second, a
  bottleneck's third): scale a tenth of that, [0.08, 0.12], so that each
  block starts near the identity, as trained residual blocks are and as
  zero-scale initialisation (Goyal et al. 2017) starts them. With full
  scales, batch-statistics BatchNorm at this depth amplifies any rounding
  from block to block until the outputs of a training step are noise
  whatever the precision (bfloat16 moved the refine logits by 34% of their
  norm, float8 by 63%), and no comparison could tell them apart.

`center_heads` then moves the RoI bit's and the seg channels' biases so that
the reference's median logit of each is 0 on a few crops: random weights
otherwise mark every keypoint of every crop in or out of the RoI alike,
seed by seed, and a seed that marks none leaves the solver nothing to
solve and the check nothing to judge.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from posebench.reference import model as ref

_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))     # CDF of -2
_TRUNC_STD = 0.87962566103423978                        # std of N(0,1) cut to [-2, 2]
BN_RANGES = {"weight": (0.8, 1.2), "bias": (-0.1, 0.1), "running_mean": (-0.1, 0.1),
             "running_var": (0.8, 1.25)}
RESIDUAL_SCALE = 0.1


def _entries(net: torch.nn.Module):
    """(name, shape, kind, fan_in) for every parameter and buffer."""
    residual = {f"{n}.conv2" for n, m in net.named_modules() if isinstance(m, ref.BasicBlock)}
    residual |= {f"{n}.conv3" for n, m in net.named_modules() if isinstance(m, ref.Bottleneck)}
    for mname, m in net.named_modules():
        tensors = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
        for pname, t in tensors:
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(m, ref.BatchNorm):
                last = mname.endswith((".conv2.bn", ".conv3.bn")) and mname[:-3] in residual
                yield name, tuple(t.shape), ("bn", pname, last), 0
            elif pname == "bias":
                yield name, tuple(t.shape), ("bias",), 0
            elif isinstance(m, ref.ConvTranspose2d):
                yield name, tuple(t.shape), ("kernel",), t.shape[0] * t[0, 0].numel()
            else:                                      # Conv2d (O, I, k, k), Dense (O, I)
                yield name, tuple(t.shape), ("kernel",), t[0].numel()


def make_state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of the network `cfg` describes, drawn from `seed`."""
    with torch.device("meta"):
        net = ref.build(cfg, device="meta")
    entries = list(_entries(net))
    total = sum(math.prod(shape) for _, shape, _, _ in entries)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in entries:
        n = math.prod(shape)
        s = u[at:at + n].view(shape)
        at += n
        if kind[0] == "kernel":
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            p = _LO + s * (1.0 - 2.0 * _LO)
            out[name] = torch.erfinv(2.0 * p - 1.0) * (math.sqrt(2.0) * std)
        else:
            lo, hi = BN_RANGES[kind[1]] if kind[0] == "bn" else (-0.05, 0.05)
            if kind[0] == "bn" and kind[1] == "weight" and kind[2]:
                lo, hi = RESIDUAL_SCALE * lo, RESIDUAL_SCALE * hi
            out[name] = lo + (hi - lo) * s
    return out


def param_count(cfg: Dict) -> int:
    """Parameters (not BatchNorm statistics) of the network `cfg` describes."""
    with torch.device("meta"):
        net = ref.build(cfg, device="meta")
    return sum(p.numel() for p in net.parameters())


def center_heads(state: Dict[str, torch.Tensor], cfg: Dict, imgs: torch.Tensor,
                 knn: torch.Tensor) -> None:
    """Shift, in place, the RoI logit's and each seg channel's bias by the
    float32 reference's median of that logit over `imgs` (normalised NHWC
    crops) on the graph `knn`."""
    ref.set_reference_flags()
    net = ref.build(cfg).to(imgs.device)
    net.load_state_dict(state)
    with torch.no_grad():
        out = net(imgs, knn)
    state["init_net.mlp.bias"][0] -= out["roi_logit"].median()
    seg = out["seg_logits"].flatten(0, 2)
    state["seg_block.bias"] -= seg.median(0).values
