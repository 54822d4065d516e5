"""Model operations a crop or a training image, counted by the benchmark on
its own reference under torch's FlopCounterMode (products and convolutions,
forward, and backward for training) on the meta device, so that the count
stays the same whatever implements the work. One multiply-add counts 2."""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from posebench.reference import model as ref


def _inputs(cfg: Dict, batch: int, per_sample: bool):
    npoint, k = cfg.get("npoint", 512), 20
    img = torch.zeros(batch, 256, 256, 3)
    knn = torch.zeros((batch, npoint, k) if per_sample else (npoint, k), dtype=torch.long)
    return img, knn


def forward_flops(cfg: Dict, per_sample: bool = False) -> float:
    """Operations of one crop's forward (stage = all refine stages)."""
    with torch.device("meta"):
        net = ref.build(cfg, device="meta")
        img, knn = _inputs(cfg, 1, per_sample)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            net(img, knn)
    return float(fc.get_total_flops())


def train_flops(cfg: Dict, batch: int = 2) -> float:
    """Operations of one image's training step: forward and backward."""
    with torch.device("meta"):
        net = ref.build(cfg, device="meta").train()
        img, knn = _inputs(cfg, batch, False)
        with FlopCounterMode(display=False) as fc:
            out = net(img, knn)
            loss = sum(v.float().sum() for k, v in out.items() if v.is_floating_point())
            loss.backward()
    return float(fc.get_total_flops()) / batch
