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

A reference module may declare the draws of its own tensors instead, in a
class attribute `draws` that maps a tensor's name to the (lo, hi) of a
uniform draw: a LayerNorm's scale or a layer scale, which the kernel rule
would draw at a fan-in of 1. A backbone's file declares them for its own
modules (`reference/backbones/`); the rules above hold for every tensor
that no module declares.

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


def _kind(m: torch.nn.Module, mname: str, pname: str, t, residual) -> tuple:
    """How tensor `pname` of module `mname` is drawn: ("uniform", lo, hi) or
    ("kernel", fan_in)."""
    declared = getattr(m, "draws", {})
    if pname in declared:
        return ("uniform", *declared[pname])
    if isinstance(m, ref.BatchNorm):
        lo, hi = BN_RANGES[pname]
        last = mname.endswith((".conv2.bn", ".conv3.bn")) and mname[:-3] in residual
        if pname == "weight" and last:
            return "uniform", RESIDUAL_SCALE * lo, RESIDUAL_SCALE * hi
        return "uniform", lo, hi
    if pname == "bias":
        return "uniform", -0.05, 0.05
    if isinstance(m, ref.ConvTranspose2d):
        return "kernel", t.shape[0] * t[0, 0].numel()
    return "kernel", t[0].numel()                  # Conv2d (O, I, k, k), Dense (O, I)


def _entries(net: torch.nn.Module):
    """(name, shape, kind) for every parameter and buffer, in the order of
    `named_modules()`: the order of the draw."""
    residual = {f"{n}.conv2" for n, m in net.named_modules() if isinstance(m, ref.BasicBlock)}
    residual |= {f"{n}.conv3" for n, m in net.named_modules() if isinstance(m, ref.Bottleneck)}
    for mname, m in net.named_modules():
        tensors = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
        for pname, t in tensors:
            name = f"{mname}.{pname}" if mname else pname
            yield name, tuple(t.shape), _kind(m, mname, pname, t, residual)


def make_state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of the network `cfg` describes, drawn from `seed`."""
    with torch.device("meta"):
        net = ref.build(cfg, device="meta")
    entries = list(_entries(net))
    total = sum(math.prod(shape) for _, shape, _ in entries)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in entries:
        n = math.prod(shape)
        s = u[at:at + n].view(shape)
        at += n
        if kind[0] == "kernel":
            std = math.sqrt(1.0 / kind[1]) / _TRUNC_STD
            p = _LO + s * (1.0 - 2.0 * _LO)
            out[name] = torch.erfinv(2.0 * p - 1.0) * (math.sqrt(2.0) * std)
        else:
            lo, hi = kind[1:]
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
