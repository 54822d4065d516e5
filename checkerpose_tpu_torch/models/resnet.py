"""ResNet-34 feature backbone on NCHW (counterpart of
checkerpose_tpu/models/resnet.py).

Four maps at strides 4/8/16/32 with channels 64/128/256/512, the timm
`features_only` pyramid with out_indices (1, 2, 3, 4). Module names match
the Flax tree (stem, layer{s}_block{b}).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from checkerpose_tpu_torch.models.layers import BasicBlock, ConvBNAct

# (width, blocks, stride of the first block) per stage
_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class ResNet34Features(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        # 7x7/2 under SAME: pads (2, 3) on an even input, as Flax does
        self.stem = ConvBNAct(3, 64, 7, 2, F.relu, dtype=dtype)
        cin = 64
        for s, (width, blocks, stride) in enumerate(_STAGES):
            for b in range(blocks):
                self.add_module(f"layer{s + 1}_block{b}", BasicBlock(
                    cin, width, stride if b == 0 else 1, dtype=dtype))
                cin = width

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 3, H, W) -> [(B,64,H/4,W/4), ..., (B,512,H/32,W/32)]."""
        x = F.max_pool2d(self.stem(x), 3, 2, padding=1)     # pads with -inf, as Flax
        feats = []
        for s, (_, blocks, _) in enumerate(_STAGES):
            for b in range(blocks):
                x = getattr(self, f"layer{s + 1}_block{b}")(x)
            feats.append(x)
        return feats
