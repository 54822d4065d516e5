"""Initial keypoint localization net, coarse 8x8 codes (counterpart of
checkerpose_tpu/models/init_net.py::InitNet).

Backbone stride-32 map (B, C, 8, 8) -> 1x1 conv to npoint channels -> each
keypoint's 8x8 response map flattened to its 64-d graph feature -> EdgeConv
stack -> per-keypoint Dense emitting 1 + 2*res_log2 bit logits (f32).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from checkerpose_tpu_torch.models.backbone import BACKBONE_FEAT_DIMS, make_backbone
from checkerpose_tpu_torch.models.graph import EdgeConv
from checkerpose_tpu_torch.models.layers import Conv2d, Dense
from checkerpose_tpu_torch.utils.logging import span

# the graph feature is the flattened 8x8 stride-32 map of a 256 crop
_GRID_FEAT = 64


class InitNet(nn.Module):
    def __init__(self, npoint: int, res_log2: int = 3, backbone_name: str = "hrnet_w18",
                 num_conv1x1: int = 1, num_graph_module: int = 2,
                 graph_leaky_slope: float = 0.2, dtype=torch.bfloat16):
        super().__init__()
        self.res_log2 = res_log2
        self.num_conv1x1 = num_conv1x1
        self.num_graph_module = num_graph_module
        self.dtype = dtype
        self.backbone = make_backbone(backbone_name, dtype=dtype)
        cin = BACKBONE_FEAT_DIMS[backbone_name][-1]
        for i in range(num_conv1x1):
            self.add_module(f"conv1x1_{i}", Conv2d(cin if i == 0 else npoint, npoint, 1,
                                                   bias=True, dtype=dtype))
        for i in range(num_graph_module):
            self.add_module(f"graph_{i}", EdgeConv(_GRID_FEAT, _GRID_FEAT,
                                                   graph_leaky_slope, dtype=dtype))
        self.mlp = Dense(_GRID_FEAT, 1 + 2 * res_log2, dtype=torch.float32)

    @property
    def num_out_bits(self) -> int:
        """Bit logits a keypoint: the RoI bit, then res_log2 for x and for y."""
        return 1 + 2 * self.res_log2

    def forward(self, img, knn_idx):
        """img (B, 3, H, W) normalized; knn_idx (N, K) int32.

        Returns (bits (B, N, 1+2*res_log2) f32, feats list (NCHW),
        graph_feat (B, N, 64), resp_map (B, N, 64)). resp_map is each
        keypoint's 8x8 response map before the graph, the logits of the
        auxiliary heatmap loss (train/steps.py::_aux_heatmap_loss; the JAX
        package sows it as an intermediate)."""
        with span("posenet.backbone", img.device):
            feats = self.backbone(img.to(self.dtype))
        with span("posenet.init_head", img.device):
            x = self.conv1x1_0(feats[-1])
            for i in range(1, self.num_conv1x1):
                x = getattr(self, f"conv1x1_{i}")(F.leaky_relu(x, 0.01))
            # (B, N, H, W) -> (B, N, H*W): each keypoint's own map, row-major,
            # the order of the JAX (B,H,W,N) -> (B,N,H,W) -> (B,N,H*W) reshape
            B, N, H, W = x.shape
            resp_map = g = x.reshape(B, N, H * W)
            for i in range(self.num_graph_module):
                g = getattr(self, f"graph_{i}")(g, knn_idx)
            bits = self.mlp(g.float())
        return bits, feats, g, resp_map
