"""Dense NOCS head for backbone pretraining (counterpart of
checkerpose_tpu/models/nocs.py).

NOCSNet = a backbone of the registry, kept as `backbone` so that its
checkpoint's `backbone.*` entries graft into an InitNet
(cli/common.py::maybe_graft_pretrained_backbone), and a small conv head on
the finest feature map predicting 4 channels: 3 normalized object
coordinates in [0, 1] and a visibility logit.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from checkerpose_tpu_torch.models.backbone import BACKBONE_FEAT_DIMS, make_backbone
from checkerpose_tpu_torch.models.layers import Conv2d


class NOCSNet(nn.Module):
    def __init__(self, backbone_name: str = "hrnet_w18", head_width: int = 128,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.backbone = make_backbone(backbone_name, dtype=dtype)
        self.head_conv0 = Conv2d(BACKBONE_FEAT_DIMS[backbone_name][0], head_width, 3,
                                 bias=True, dtype=dtype)
        self.head_out = Conv2d(head_width, 4, 1, bias=True, dtype=torch.float32)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) normalized NHWC -> (B, h, w, 4) f32 at the finest
        map's grid (H/4 for resnet34 and HRNet): channels 0-2 the sigmoid
        NOCS, channel 3 the visibility logit."""
        feats = self.backbone(img.permute(0, 3, 1, 2).to(self.dtype))
        x = F.leaky_relu(self.head_conv0(feats[0]), 0.01)
        out = self.head_out(x.float()).permute(0, 2, 3, 1)
        return torch.cat([torch.sigmoid(out[..., :3]), out[..., 3:4]], dim=-1)
