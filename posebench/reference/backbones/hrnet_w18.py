"""HRNet-w18 (Wang et al., "Deep High-Resolution Representation Learning",
arXiv:1908.07919), the backbone of the single-object configurations, with
the incre bottlenecks that widen its four branches to the pyramid below."""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from posebench.reference.model import BasicBlock, Bottleneck, ConvBNAct, run

DIMS = (128, 256, 512, 1024)


class Features(nn.Module):
    """HRNet-w18: stem, 4 bottlenecks, then stages of 1 / 4 / 3 modules of
    4 basic blocks a branch (widths 18 / 36 / 72 / 144) with full fusion,
    and one bottleneck a branch to 128 / 256 / 512 / 1024 channels."""
    widths = (18, 36, 72, 144)
    modules_per_stage = (1, 4, 3)

    def __init__(self):
        super().__init__()
        self.stem1 = ConvBNAct(3, 64, 3, 2)
        self.stem2 = ConvBNAct(64, 64, 3, 2)
        c = 64
        for k in range(4):
            self.add_module(f"layer1_block{k}", Bottleneck(c, 64))
            c = 256
        chans = [c]
        for s in range(3):
            ws = self.widths[:s + 2]
            for b in range(s + 1):
                if chans[b] != ws[b]:
                    self.add_module(f"t{s}_adapt{b}", ConvBNAct(chans[b], ws[b], 3, 1))
            self.add_module(f"t{s}_new", ConvBNAct(chans[-1], ws[-1], 3, 2))
            chans = list(ws)
            for m in range(self.modules_per_stage[s]):
                mod = nn.Module()
                for b, w in enumerate(ws):
                    for k in range(4):
                        mod.add_module(f"branch{b}_block{k}", BasicBlock(w, w))
                fuse = nn.Module()
                for i in range(len(ws)):
                    for j in range(len(ws)):
                        if j > i:
                            fuse.add_module(f"up_{j}_to_{i}",
                                            ConvBNAct(ws[j], ws[i], 1, relu=False))
                        for t in range(i - j):
                            last = t == i - j - 1
                            fuse.add_module(f"down_{j}_to_{i}_{t}", ConvBNAct(
                                ws[j], ws[i] if last else ws[j], 3, 2, relu=not last))
                mod.add_module("fuse", fuse)
                self.add_module(f"stage{s + 2}_module{m}", mod)
        for b, w in enumerate(self.widths):
            self.add_module(f"incre{b}", Bottleneck(w, 32 * 2 ** b))

    def _module(self, mod, xs):
        n = len(xs)
        ys = []
        for b, x in enumerate(xs):
            for k in range(4):
                x = getattr(mod, f"branch{b}_block{k}")(x)
            ys.append(x)
        outs = []
        for i in range(n):
            acc = 0
            for j in range(n):
                if j == i:
                    y = ys[j]
                elif j > i:
                    y = F.interpolate(getattr(mod.fuse, f"up_{j}_to_{i}")(ys[j]),
                                      scale_factor=2 ** (j - i), mode="nearest")
                else:
                    y = ys[j]
                    for t in range(i - j):
                        y = getattr(mod.fuse, f"down_{j}_to_{i}_{t}")(y)
                acc = acc + y
            outs.append(F.relu(acc))
        return outs

    def forward(self, x) -> List[torch.Tensor]:
        x = run(self, lambda v: self.stem2(self.stem1(v)), x)
        for k in range(4):
            x = run(self, getattr(self, f"layer1_block{k}"), x)
        xs = [x]
        for s in range(3):
            new = []
            for b in range(s + 1):
                adapt = getattr(self, f"t{s}_adapt{b}", None)
                new.append(xs[b] if adapt is None else adapt(xs[b]))
            new.append(getattr(self, f"t{s}_new")(xs[-1]))
            xs = new
            for m in range(self.modules_per_stage[s]):
                mod = getattr(self, f"stage{s + 2}_module{m}")
                xs = list(run(self, lambda *v, mod=mod: tuple(self._module(mod, list(v))), *xs))
        return [run(self, getattr(self, f"incre{b}"), x) for b, x in enumerate(xs)]
