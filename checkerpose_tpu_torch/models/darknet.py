"""DarkNet-53 feature backbone on NCHW (counterpart of
checkerpose_tpu/models/darknet.py).

Five maps at strides 2/4/8/16/32 with channels 64/128/256/512/1024, the timm
`features_only` pyramid with out_indices (1..5): leaky-ReLU (0.1) conv-BN
layers, a stride-2 3x3 conv opening each stage, 1x1/3x3 residual pairs.
Module names match the Flax tree (stem, down{s}, stage{s}_block{b}).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from checkerpose_tpu_torch.models.layers import ConvBNAct

# (width, residual blocks) per stage
_STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


class DarkBlock(nn.Module):
    """Squeeze to features // 2 with a 1x1, back with a 3x3, plus the input."""

    def __init__(self, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = ConvBNAct(features, features // 2, 1, 1, _lrelu, dtype=dtype)
        self.conv2 = ConvBNAct(features // 2, features, 3, 1, _lrelu, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class DarkNet53Features(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = ConvBNAct(3, 32, 3, 1, _lrelu, dtype=dtype)
        cin = 32
        for s, (width, blocks) in enumerate(_STAGES):
            # 3x3/2 under SAME: pads (0, 1) on an even input
            self.add_module(f"down{s}", ConvBNAct(cin, width, 3, 2, _lrelu, dtype=dtype))
            for b in range(blocks):
                self.add_module(f"stage{s}_block{b}", DarkBlock(width, dtype=dtype))
            cin = width

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 3, H, W) -> [(B,64,H/2,W/2), ..., (B,1024,H/32,W/32)]."""
        x = self.stem(x.to(self.dtype))
        feats = []
        for s, (_, blocks) in enumerate(_STAGES):
            x = getattr(self, f"down{s}")(x)
            for b in range(blocks):
                x = getattr(self, f"stage{s}_block{b}")(x)
            feats.append(x)
        return feats
