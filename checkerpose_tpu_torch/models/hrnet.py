"""HRNet feature backbone on NCHW (counterpart of
checkerpose_tpu/models/hrnet.py).

Four maps at strides 4/8/16/32 with channels 128/256/512/1024. Module names
match the Flax tree (stem1, layer1_block{k}, t{s}_adapt{b}, t{s}_new,
stage{s}_module{m}/branch{b}_block{k}, .../fuse/up_{j}_to_{i},
.../fuse/down_{j}_to_{i}_{s}, incre{b}).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from checkerpose_tpu_torch.models.layers import BasicBlock, Bottleneck, ConvBNAct


def _upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class FuseLayer(nn.Module):
    """Every output branch sums every input branch (1x1 + nearest-up from
    coarser, a chain of stride-2 3x3 convs from finer), then ReLU."""

    def __init__(self, widths: Sequence[int], dtype=torch.bfloat16):
        super().__init__()
        self.widths = tuple(widths)
        n = len(widths)
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"up_{j}_to_{i}", ConvBNAct(
                        widths[j], widths[i], 1, 1, None, dtype=dtype))
                elif j < i:
                    c = widths[j]
                    for s in range(i - j):
                        last = s == i - j - 1
                        out = widths[i] if last else widths[j]
                        self.add_module(f"down_{j}_to_{i}_{s}", ConvBNAct(
                            c, out, 3, 2, None if last else F.relu, dtype=dtype))
                        c = out

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n = len(self.widths)
        outs = []
        for i in range(n):
            acc = None
            for j in range(n):
                if j == i:
                    y = xs[j]
                elif j > i:
                    y = _upsample_nearest(getattr(self, f"up_{j}_to_{i}")(xs[j]),
                                          2 ** (j - i))
                else:
                    y = xs[j]
                    for s in range(i - j):
                        y = getattr(self, f"down_{j}_to_{i}_{s}")(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRModule(nn.Module):
    """num_blocks BasicBlocks per branch, then fuse."""

    def __init__(self, widths: Sequence[int], num_blocks: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.widths = tuple(widths)
        self.num_blocks = num_blocks
        for b, w in enumerate(widths):
            for k in range(num_blocks):
                self.add_module(f"branch{b}_block{k}", BasicBlock(w, w, 1, dtype=dtype))
        self.fuse = FuseLayer(widths, dtype=dtype)

    def forward(self, xs):
        ys = []
        for b, x in enumerate(xs):
            for k in range(self.num_blocks):
                x = getattr(self, f"branch{b}_block{k}")(x)
            ys.append(x)
        return self.fuse(ys)


_HRNET_CFGS = {
    # name: (widths, stage_modules (s2, s3, s4), blocks_per_module)
    "hrnet_w18": ((18, 36, 72, 144), (1, 4, 3), 4),
    "hrnet_w30": ((30, 60, 120, 240), (1, 4, 3), 4),
    "hrnet_w18_small": ((18, 36, 72, 144), (1, 1, 1), 2),
}


class HRNetFeatures(nn.Module):
    def __init__(self, name_cfg: str = "hrnet_w18", dtype=torch.bfloat16):
        super().__init__()
        widths, stage_modules, blocks = _HRNET_CFGS[name_cfg]
        self.stage_modules = stage_modules
        self.stem1 = ConvBNAct(3, 64, 3, 2, F.relu, dtype=dtype)
        self.stem2 = ConvBNAct(64, 64, 3, 2, F.relu, dtype=dtype)
        self.n_l1 = 4 if blocks == 4 else 2
        c = 64
        for k in range(self.n_l1):
            self.add_module(f"layer1_block{k}", Bottleneck(c, 64, 1, dtype=dtype))
            c = 256
        chans = [c]
        for stage in range(3):
            n_br = stage + 2
            ws = widths[:n_br]
            for b in range(n_br - 1):
                if chans[b] != ws[b]:
                    self.add_module(f"t{stage}_adapt{b}", ConvBNAct(
                        chans[b], ws[b], 3, 1, F.relu, dtype=dtype))
            self.add_module(f"t{stage}_new", ConvBNAct(
                chans[-1], ws[-1], 3, 2, F.relu, dtype=dtype))
            chans = list(ws)
            for m in range(stage_modules[stage]):
                self.add_module(f"stage{stage + 2}_module{m}",
                                HRModule(ws, blocks, dtype=dtype))
        for b, w in enumerate(widths):
            self.add_module(f"incre{b}", Bottleneck(w, 32 * (2 ** b), 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 3, H, W) -> [(B,128,H/4,W/4), ..., (B,1024,H/32,W/32)]."""
        x = self.stem2(self.stem1(x))
        for k in range(self.n_l1):
            x = getattr(self, f"layer1_block{k}")(x)
        xs = [x]
        for stage in range(3):
            n_br = stage + 2
            new_xs = []
            for b in range(n_br - 1):
                adapt = getattr(self, f"t{stage}_adapt{b}", None)
                new_xs.append(xs[b] if adapt is None else adapt(xs[b]))
            new_xs.append(getattr(self, f"t{stage}_new")(xs[-1]))
            xs = new_xs
            for m in range(self.stage_modules[stage]):
                xs = getattr(self, f"stage{stage + 2}_module{m}")(xs)
        return [getattr(self, f"incre{b}")(x) for b, x in enumerate(xs)]
