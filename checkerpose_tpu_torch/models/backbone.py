"""Backbone registry (counterpart of checkerpose_tpu/models/backbone.py):
the reference's supported set and its channel tables."""
from __future__ import annotations

import torch

from checkerpose_tpu_torch.models.convnext import _CONVNEXT_CFGS, ConvNeXtFeatures
from checkerpose_tpu_torch.models.darknet import DarkNet53Features
from checkerpose_tpu_torch.models.hrnet import _HRNET_CFGS, HRNetFeatures
from checkerpose_tpu_torch.models.resnet import ResNet34Features

# channels of the multi-scale feature pyramid, coarse last
BACKBONE_FEAT_DIMS = {
    "resnet34": [64, 128, 256, 512],
    "hrnet_w18": [128, 256, 512, 1024],
    "hrnet_w18_small": [128, 256, 512, 1024],
    "hrnet_w30": [128, 256, 512, 1024],
    "convnext_tiny": [192, 384, 768],
    "convnext_small": [192, 384, 768],
    "convnext_base": [256, 512, 1024],
    "darknet53": [64, 128, 256, 512, 1024],
}


def make_backbone(name: str, dtype=torch.bfloat16):
    if name == "resnet34":
        return ResNet34Features(dtype=dtype)
    if name in _HRNET_CFGS:
        return HRNetFeatures(name_cfg=name, dtype=dtype)
    if name in _CONVNEXT_CFGS:
        return ConvNeXtFeatures(name_cfg=name, dtype=dtype)
    if name == "darknet53":
        return DarkNet53Features(dtype=dtype)
    raise ValueError(f"backbone {name} not supported")
