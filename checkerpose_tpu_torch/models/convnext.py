"""ConvNeXt feature backbone on NCHW (counterpart of
checkerpose_tpu/models/convnext.py).

Three maps at strides 8/16/32 with channels 192/384/768 (tiny, small) or
256/512/1024 (base), the timm `features_only` pyramid with out_indices
(1, 2, 3): a 4x4/4 patchify stem, LayerNorm + 2x2/2 conv between stages,
blocks of a depthwise 7x7, LayerNorm, a pointwise MLP and a layer scale.
Module and parameter names match the Flax tree (stem_conv, stem_norm,
down{s}_norm, down{s}_conv, stage{s}_block{b}/{dwconv, norm, pwconv1,
pwconv2, gamma}).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from checkerpose_tpu_torch.models.layers import Conv2d, Dense, LayerNorm

_CONVNEXT_CFGS = {
    # name: (widths, blocks per stage)
    "convnext_tiny": ((96, 192, 384, 768), (3, 3, 9, 3)),
    "convnext_small": ((96, 192, 384, 768), (3, 3, 27, 3)),
    "convnext_base": ((128, 256, 512, 1024), (3, 3, 27, 3)),
}


class ConvNeXtBlock(nn.Module):
    """x + gamma * pwconv2(gelu(pwconv1(norm(dwconv(x))))). The pointwise
    layers are Dense on a channels-last view (Flax's kernels are (I, O));
    the norm computes in f32; GELU is the tanh approximation, Flax's
    `nn.gelu` default."""

    layer_scale_init = 1e-6

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.dwconv = Conv2d(dim, dim, 7, bias=True, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim)
        self.pwconv1 = Dense(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Dense(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), self.layer_scale_init))

    def reset_parameters(self, generator=None):
        nn.init.constant_(self.gamma, self.layer_scale_init)

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)                     # (B, H, W, C)
        y = self.norm(y, channel_dim=-1).to(self.dtype)
        y = self.pwconv2(F.gelu(self.pwconv1(y), approximate="tanh"))
        return x + (y * self.gamma.to(y.dtype)).permute(0, 3, 1, 2)


class ConvNeXtFeatures(nn.Module):
    def __init__(self, name_cfg: str = "convnext_tiny", dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        dims, depths = _CONVNEXT_CFGS[name_cfg]
        self.depths = depths
        self.stem_conv = Conv2d(3, dims[0], 4, 4, bias=True, dtype=dtype)
        self.stem_norm = LayerNorm(dims[0])
        for s in range(1, 4):
            self.add_module(f"down{s}_norm", LayerNorm(dims[s - 1]))
            self.add_module(f"down{s}_conv", Conv2d(dims[s - 1], dims[s], 2, 2, bias=True,
                                                    dtype=dtype))
        for s in range(4):
            for b in range(depths[s]):
                self.add_module(f"stage{s}_block{b}", ConvNeXtBlock(dims[s], dtype=dtype))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 3, H, W) -> [(B,C1,H/8,W/8), (B,C2,H/16,W/16), (B,C3,H/32,W/32)]."""
        x = x.to(self.dtype)
        feats = []
        for s in range(4):
            if s == 0:
                x = self.stem_norm(self.stem_conv(x)).to(self.dtype)
            else:
                x = getattr(self, f"down{s}_norm")(x).to(self.dtype)
                x = getattr(self, f"down{s}_conv")(x)
            for b in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{b}")(x)
            feats.append(x)
        return feats[1:]        # the stride-4 map is not part of the pyramid
