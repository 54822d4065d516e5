"""The "without progressive localization" ablation (counterpart of
checkerpose_tpu/models/ablation.py; the reference's `PoseNet_GNNskip_ABwoProg`,
cfg `network_type = vanilla_GNNskip_ABwoProg`).

The refinement stages only refine graph features (an EdgeConv stack after a
channel MLP, no location-indexed gathers, no per-stage bit queries); one final
MLP query emits all 1 + 2*res_log2 bit logits at once, so the ids are at full
resolution at every stage. The other ablations are config values only:
`_woEdgeConv` and `init_gnn0` set the graph module counts to 0, `_woVisibMask`
and `_woFullMask` a seg loss weight to 0. Module names follow the Flax tree,
so models/convert.py maps the variables with no rule of its own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from checkerpose_tpu_torch.models.backbone import BACKBONE_FEAT_DIMS
from checkerpose_tpu_torch.models.graph import EdgeConv
from checkerpose_tpu_torch.models.init_net import _GRID_FEAT, InitNet
from checkerpose_tpu_torch.models.layers import Conv2d, Dense
from checkerpose_tpu_torch.models.posenet import UpBlock, _hard_ids


class FeatureRefineBlock(nn.Module):
    """Channel conversion MLP + EdgeConv stack on the graph features; no
    image-feature gather."""

    def __init__(self, graph_dim: int, query_dim: int = 256, leaky_slope: float = 0.01,
                 num_graph_module: int = 2, graph_leaky_slope: float = 0.2,
                 dtype=torch.bfloat16):
        super().__init__()
        self.leaky_slope = leaky_slope
        self.num_graph_module = num_graph_module
        self.dtype = dtype
        self.pre_graph_0 = Dense(graph_dim, query_dim, dtype=dtype)
        self.pre_graph_1 = Dense(query_dim, query_dim, dtype=dtype)
        for i in range(num_graph_module):
            self.add_module(f"graph_{i}", EdgeConv(query_dim, query_dim, graph_leaky_slope,
                                                   dtype=dtype))

    def forward(self, graph_feat, knn_idx):
        x = F.leaky_relu(self.pre_graph_0(graph_feat.to(self.dtype)), self.leaky_slope)
        x = F.leaky_relu(self.pre_graph_1(x), self.leaky_slope)
        for i in range(self.num_graph_module):
            x = getattr(self, f"graph_{i}")(x, knn_idx)
        return x


class PoseNetWoProg(nn.Module):
    """Init net (features only), UpBlocks beside FeatureRefineBlocks, seg
    head, and one query MLP for every bit."""

    def __init__(self, npoint: int, res_log2: int = 6, backbone_name: str = "hrnet_w18",
                 num_filters: int = 256, query_dims: Tuple[int, ...] = (256, 256, 64),
                 seg_output_dim: int = 2, leaky_slope: float = 0.01,
                 num_graph_module: int = 2, graph_leaky_slope: float = 0.2,
                 init_num_conv1x1: int = 1, init_num_graph_module: int = 2,
                 init_graph_leaky_slope: float = 0.2, dtype=torch.bfloat16):
        super().__init__()
        self.npoint = npoint
        self.res_log2 = res_log2
        self.leaky_slope = leaky_slope
        self.dtype = dtype
        self.aux_refine_heads = False
        self.n_query = len(query_dims) - 1
        self.init_net = InitNet(npoint, 3, backbone_name, init_num_conv1x1,
                                init_num_graph_module, init_graph_leaky_slope, dtype=dtype)
        dims = BACKBONE_FEAT_DIMS[backbone_name]
        for i in range(self.num_refine_steps):
            cin = dims[-1] if i == 0 else num_filters + dims[-i - 1]
            self.add_module(f"up_{i}", UpBlock(cin, num_filters, i == 0, dtype=dtype))
            self.add_module(f"refine_{i}", FeatureRefineBlock(
                _GRID_FEAT if i == 0 else query_dims[0], query_dims[0], leaky_slope,
                num_graph_module, graph_leaky_slope, dtype=dtype))
        self.seg_block = Conv2d(num_filters, seg_output_dim, 1, bias=True,
                                dtype=torch.float32)
        d_in = query_dims[0]
        for i, d in enumerate(query_dims[1:]):
            self.add_module(f"query_{i}", Dense(d_in, d, dtype=dtype))
            d_in = d
        self.query_out = Dense(d_in, 1 + 2 * res_log2, dtype=torch.float32)

    @property
    def num_refine_steps(self) -> int:
        return self.res_log2 - 3

    def output_res_log2(self, stage: Optional[int]) -> int:
        """The one query head emits all res_log2 bits, so the ids are at full
        resolution at every stage; the eval harness decodes at this one."""
        return self.res_log2

    def forward(self, img, knn_idx, p3d_normed=None, stage: Optional[int] = None):
        """img (B, H, W, 3) normalized NHWC; knn_idx (N, K) or (B, N, K)
        int32; p3d_normed is unused. Returns PoseNet's dict with x_logits /
        y_logits (B, N, res_log2) and ids at 2**res_log2 at every stage;
        in train mode also resp_map (B, N, 64), the init net's response maps."""
        num_active = self.num_refine_steps if stage is None else stage
        if not 1 <= num_active <= self.num_refine_steps:
            raise ValueError(f"stage must be in [1, {self.num_refine_steps}], got {stage}")
        # the init net's localization is discarded; only its features are kept
        _, feats, graph_feat, resp_map = self.init_net(img.permute(0, 3, 1, 2), knn_idx)
        img_feat = feats[-1]
        for i in range(num_active):
            if i > 0:
                img_feat = torch.cat([img_feat, feats[-i - 1].to(img_feat.dtype)], dim=1)
            img_feat = getattr(self, f"up_{i}")(img_feat)
            graph_feat = getattr(self, f"refine_{i}")(graph_feat, knn_idx)
        seg_logits = self.seg_block(img_feat.float()).permute(0, 2, 3, 1)
        q = graph_feat
        for i in range(self.n_query):
            q = F.leaky_relu(getattr(self, f"query_{i}")(q), self.leaky_slope)
        bits = self.query_out(q.float())
        L = self.res_log2
        x_logits, y_logits = bits[..., 1:1 + L], bits[..., 1 + L:]
        out = {"roi_logit": bits[..., 0:1], "x_logits": x_logits, "y_logits": y_logits,
               "seg_logits": seg_logits, "x_id": _hard_ids(x_logits),
               "y_id": _hard_ids(y_logits)}
        if self.training:
            out["resp_map"] = resp_map
        return out
