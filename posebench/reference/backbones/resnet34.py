"""ResNet-34 (He et al., "Deep Residual Learning", arXiv:1512.03385), the
backbone of the LM multi-object configuration."""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from posebench.reference.model import BasicBlock, ConvBNAct, run

DIMS = (64, 128, 256, 512)


class Features(nn.Module):
    """torchvision's ResNet-34 features at strides 4 / 8 / 16 / 32 (a 7x7/2
    stem, a 3x3/2 max pool, 3 / 4 / 6 / 3 basic blocks)."""
    stages = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self):
        super().__init__()
        self.stem = ConvBNAct(3, 64, 7, 2)
        cin = 64
        for s, (w, n, stride) in enumerate(self.stages):
            for b in range(n):
                self.add_module(f"layer{s + 1}_block{b}",
                                BasicBlock(cin, w, stride if b == 0 else 1))
                cin = w

    def forward(self, x):
        x = run(self, lambda v: F.max_pool2d(self.stem(v), 3, 2, padding=1), x)
        feats = []
        for s, (_, n, _) in enumerate(self.stages):
            for b in range(n):
                x = run(self, getattr(self, f"layer{s + 1}_block{b}"), x)
            feats.append(x)
        return feats
