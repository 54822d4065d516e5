"""Train CLI of the port (counterpart of checkerpose_tpu/cli/train.py).

Only `build_pose_net` is ported so far, for the test CLI; the training entry
point itself is ROADMAP queue 1, item 3.
"""
from __future__ import annotations

import torch

from checkerpose_tpu_torch.models.posenet import PoseNet


def build_pose_net(cfg, npoint: int, dtype=torch.bfloat16) -> PoseNet:
    """The PoseNet a config describes (compute in `dtype`)."""
    return PoseNet(
        npoint=npoint,
        aux_refine_heads=float(cfg.get("aux_refine_heatmap_weight", 0.0)) > 0,
        res_log2=int(cfg.get("network_res_log2", 6)),
        backbone_name=cfg.get("init_network_backbone_name", "resnet34"),
        local_k=int(cfg.get("network_local_k", 2)),
        leaky_slope=float(cfg.get("network_leaky_slope", 0.01)),
        num_graph_module=int(cfg.get("network_num_graph_module", 2)),
        graph_leaky_slope=float(cfg.get("network_graph_leaky_slope", 0.2)),
        init_num_conv1x1=int(cfg.get("init_network_num_conv1x1", 1)),
        init_num_graph_module=int(cfg.get("init_network_num_graph_module", 2)),
        init_graph_leaky_slope=float(cfg.get("init_network_graph_leaky_slope", 0.2)),
        dtype=dtype,
    )
