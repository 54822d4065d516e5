"""Full progressive pose network (counterpart of
checkerpose_tpu/models/posenet.py).

The init net produces coarse 8x8 codes; each refinement step doubles the
resolution (8->16->32->64), gathers per-keypoint local features at the
current integer cells, runs an EdgeConv stack and emits one new x bit and one
new y bit per keypoint. Images enter NHWC (as in the JAX package) and run
NCHW inside; keypoint outputs are (B, N, .) and seg_logits is NHWC.

`train()` / `eval()` decides the mode of every BatchNorm and EdgeConv. The
location updates are hard and carry no gradient: the `.detach()` calls stand
where the JAX package has `stop_gradient`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.models.backbone import BACKBONE_FEAT_DIMS
from checkerpose_tpu_torch.models.graph import EdgeConv
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.layers import (BatchNorm, Conv2d, ConvTranspose2d,
                                                 Dense, init_params,
                                                 upsample_bilinear_2x)
from checkerpose_tpu_torch.ops.knn import check_knn


def _hard_bit(logits: torch.Tensor) -> torch.Tensor:
    """Detached logits -> int32 {0,1}; sigmoid(x) > 0.5 <=> x > 0."""
    return (logits.detach() > 0.0).to(torch.int32)


def _hard_ids(logits: torch.Tensor) -> torch.Tensor:
    """Detached MSB-first bit logits (B, N, L) -> integer ids (B, N) int32."""
    bits = _hard_bit(logits)
    L = bits.shape[-1]
    w = 1 << (L - 1 - torch.arange(L, dtype=torch.int32, device=logits.device))
    return (bits * w).sum(-1, dtype=torch.int32)


class UpBlock(nn.Module):
    """2x upsampler: ConvTranspose at the first step, bilinear-up + conv
    later; both followed by two conv3x3 + BN + ReLU."""

    def __init__(self, cin: int, num_filters: int = 256, is_convtrans: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.is_convtrans = is_convtrans
        self.dtype = dtype
        if is_convtrans:
            self.convT = ConvTranspose2d(cin, num_filters, 3, 2, dtype=dtype)
            self.bn0 = BatchNorm(num_filters)
            self.conv1 = Conv2d(num_filters, num_filters, 3, dtype=dtype)
        else:
            self.conv1 = Conv2d(cin, num_filters, 3, dtype=dtype)
        self.bn1 = BatchNorm(num_filters)
        self.conv2 = Conv2d(num_filters, num_filters, 3, dtype=dtype)
        self.bn2 = BatchNorm(num_filters)

    def _bn_relu(self, bn, y):
        return F.relu(bn(y).to(self.dtype))

    def forward(self, x):
        if self.is_convtrans:
            x = self._bn_relu(self.bn0, self.convT(x))
        else:
            x = upsample_bilinear_2x(x)
        x = self._bn_relu(self.bn1, self.conv1(x))
        return self._bn_relu(self.bn2, self.conv2(x))


class Index2Feat(nn.Module):
    """Patch-embed conv (kernel k, padding k-1 on both sides), then read the
    embeddings at (2u, 2v), (2u+k, 2v), (2u, 2v+k), (2u+k, 2v+k) and concat
    -> (B, N, 4E), in the JAX package's child order."""

    def __init__(self, cin: int, embed_dim: int, kernel_size: int = 2,
                 dtype=torch.bfloat16):
        super().__init__()
        self.k = kernel_size
        self.patch_conv = Conv2d(cin, embed_dim, kernel_size, padding=kernel_size - 1,
                                 bias=True, dtype=dtype)

    def forward(self, img_feat, x_id, y_id):
        k = self.k
        patches = self.patch_conv(img_feat)                     # (B, E, H', W')
        B, E, Hp, Wp = patches.shape
        flat = patches.reshape(B, E, Hp * Wp)
        by, bx = 2 * y_id.long(), 2 * x_id.long()
        lin = torch.stack([by * Wp + bx, (by + k) * Wp + bx,
                           by * Wp + (bx + k), (by + k) * Wp + (bx + k)], dim=1)  # (B, 4, N)
        N = lin.shape[-1]
        g = flat.gather(2, lin.reshape(B, 1, 4 * N).expand(B, E, 4 * N))
        return g.reshape(B, E, 4, N).permute(0, 3, 2, 1).reshape(B, N, 4 * E)


class RefineBlock(nn.Module):
    """One progressive refinement step."""

    def __init__(self, cin_img: int, graph_dim: int,
                 query_dims: Tuple[int, ...] = (256, 256, 64), local_k: int = 2,
                 leaky_slope: float = 0.01, num_graph_module: int = 2,
                 graph_leaky_slope: float = 0.2, dtype=torch.bfloat16):
        super().__init__()
        C0 = query_dims[0]
        self.leaky_slope = leaky_slope
        self.num_graph_module = num_graph_module
        self.n_query = len(query_dims) - 1
        self.index2feat = Index2Feat(cin_img, C0 // 4, local_k, dtype=dtype)
        self.pre_graph_0 = Dense(C0 + graph_dim, C0, dtype=dtype)
        self.pre_graph_1 = Dense(C0, C0, dtype=dtype)
        for i in range(num_graph_module):
            self.add_module(f"graph_{i}", EdgeConv(C0, C0, graph_leaky_slope, dtype=dtype))
        d_in = C0
        for i, d in enumerate(query_dims[1:]):
            self.add_module(f"query_{i}", Dense(d_in, d, dtype=dtype))
            d_in = d
        self.query_out = Dense(d_in, 2, dtype=torch.float32)

    def forward(self, img_feat, graph_feat, roi_mask, x_id, y_id, knn_idx):
        local = self.index2feat(img_feat, x_id, y_id)
        local = local * roi_mask.to(local.dtype)
        x = torch.cat([local, graph_feat.to(local.dtype)], dim=-1)
        x = F.leaky_relu(self.pre_graph_0(x), self.leaky_slope)
        x = F.leaky_relu(self.pre_graph_1(x), self.leaky_slope)
        for i in range(self.num_graph_module):
            x = getattr(self, f"graph_{i}")(x, knn_idx)
        q = x
        for i in range(self.n_query):
            q = F.leaky_relu(getattr(self, f"query_{i}")(q), self.leaky_slope)
        return self.query_out(q.float()), x


class PoseNet(nn.Module):
    """Progressive binary-code pose network (init + refinement + seg head)."""

    def __init__(self, npoint: int, res_log2: int = 6, backbone_name: str = "hrnet_w18",
                 num_filters: int = 256, query_dims: Tuple[int, ...] = (256, 256, 64),
                 seg_output_dim: int = 2, local_k: int = 2, leaky_slope: float = 0.01,
                 num_graph_module: int = 2, graph_leaky_slope: float = 0.2,
                 init_num_conv1x1: int = 1, init_num_graph_module: int = 2,
                 init_graph_leaky_slope: float = 0.2, aux_refine_heads: bool = False,
                 dtype=torch.bfloat16):
        """aux_refine_heads: one 1x1 conv to npoint channels on each UpBlock
        output (`aux_resp_{i}`, in the state_dict only when asked for), whose
        per-keypoint response maps feed the auxiliary refine heatmap loss
        (train/steps.py::_aux_refine_loss). They run in train mode only."""
        super().__init__()
        self.npoint = npoint
        self.res_log2 = res_log2
        self.aux_refine_heads = aux_refine_heads
        self.dtype = dtype
        self.init_net = InitNet(npoint, 3, backbone_name, init_num_conv1x1,
                                init_num_graph_module, init_graph_leaky_slope, dtype=dtype)
        dims = BACKBONE_FEAT_DIMS[backbone_name]
        for i in range(self.num_refine_steps):
            cin = dims[-1] if i == 0 else num_filters + dims[-i - 1]
            self.add_module(f"up_{i}", UpBlock(cin, num_filters, i == 0, dtype=dtype))
            self.add_module(f"refine_{i}", RefineBlock(
                num_filters, 64 if i == 0 else query_dims[0], query_dims,
                local_k, leaky_slope, num_graph_module, graph_leaky_slope, dtype=dtype))
            if aux_refine_heads:
                self.add_module(f"aux_resp_{i}", Conv2d(num_filters, npoint, 1, bias=True,
                                                        dtype=dtype))
        self.seg_block = Conv2d(num_filters, seg_output_dim, 1, bias=True,
                                dtype=torch.float32)

    @property
    def num_refine_steps(self) -> int:
        return self.res_log2 - 3

    def output_res_log2(self, stage: Optional[int]) -> int:
        return 3 + (self.num_refine_steps if stage is None else stage)

    def forward(self, img, knn_idx, p3d_normed=None, stage: Optional[int] = None,
                tf_gather=None):
        """img (B, H, W, 3) normalized NHWC; knn_idx (N, K) int32 on img's
        device; p3d_normed is unused (the query MLP ignores the 3D points).

        Returns dict: roi_logit (B, N, 1), x_logits / y_logits (B, N, 3+stage)
        f32, seg_logits (B, h, w, seg_output_dim) f32, x_id / y_id (B, N)
        int32 at resolution 2**(3 + stage). In train mode also resp_map
        (B, N, 64), the init net's per-keypoint response maps, and, with
        aux_refine_heads, refine_resp_{i} (B, N, H*W) per active stage.

        tf_gather (train mode only, ignored in eval): teacher-forced refine
        conditioning, a tuple (gt_x_id, gt_y_id, gt_roi, sel) with gt ids
        (B, N) int32 at 2**res_log2 resolution, gt_roi (B, N, 1) f32 and
        sel (B, N) bool. For selected keypoints every refine gather reads
        the GT cell (its MSB prefix at that stage's resolution) instead of
        the predicted one; the running predicted ids are unchanged."""
        num_active = self.num_refine_steps if stage is None else stage
        if not 1 <= num_active <= self.num_refine_steps:
            raise ValueError(f"stage must be in [1, {self.num_refine_steps}], got {stage}")
        x = img.permute(0, 3, 1, 2)
        bits, feats, graph_feat, resp_map = self.init_net(x, knn_idx)
        if tuple(feats[-1].shape[2:]) != (8, 8):
            raise ValueError(
                f"PoseNet refine stages require an 8x8 init feature map "
                f"(crop 256 at stride 32), got {tuple(feats[-1].shape[2:])}")
        roi_logit = bits[..., 0:1]
        x_logits = bits[..., 1:4]
        y_logits = bits[..., 4:7]
        roi_mask = (roi_logit.detach() > 0.0).float()
        x_id = _hard_ids(x_logits)
        y_id = _hard_ids(y_logits)

        out = {}
        use_tf = self.training and tf_gather is not None
        if use_tf:
            gt_x_full, gt_y_full, gt_roi, tf_sel = tf_gather
        if self.training:
            out["resp_map"] = resp_map

        img_feat = feats[-1]
        for i in range(num_active):
            if i > 0:
                img_feat = torch.cat([img_feat, feats[-i - 1].to(img_feat.dtype)], dim=1)
            img_feat = getattr(self, f"up_{i}")(img_feat)
            if self.aux_refine_heads and self.training:
                r = getattr(self, f"aux_resp_{i}")(img_feat)            # (B, N, H, W)
                out[f"refine_resp_{i}"] = r.flatten(2)
            if use_tf:
                shift = self.res_log2 - (3 + i)
                g_x = torch.where(tf_sel, gt_x_full >> shift, x_id)
                g_y = torch.where(tf_sel, gt_y_full >> shift, y_id)
                g_roi = torch.where(tf_sel[..., None], gt_roi, roi_mask)
            else:
                g_x, g_y, g_roi = x_id, y_id, roi_mask
            new_bits, graph_feat = getattr(self, f"refine_{i}")(
                img_feat, graph_feat, g_roi, g_x, g_y, knn_idx)
            x_logits = torch.cat([x_logits, new_bits[..., 0:1]], dim=-1)
            y_logits = torch.cat([y_logits, new_bits[..., 1:2]], dim=-1)
            x_id = x_id * 2 + _hard_bit(new_bits[..., 0])
            y_id = y_id * 2 + _hard_bit(new_bits[..., 1])

        seg_logits = self.seg_block(img_feat.float()).permute(0, 2, 3, 1)
        out.update({"roi_logit": roi_logit, "x_logits": x_logits, "y_logits": y_logits,
                    "seg_logits": seg_logits, "x_id": x_id, "y_id": y_id})
        return out


def make_posenet(*, device="cuda", seed: int = 0, **cfg) -> PoseNet:
    """A random-init PoseNet (Flax initialisers, drawn from a torch.Generator
    seeded with `seed`), in eval mode on `device`. `cfg` is PoseNet's."""
    dev = resolve_device(device)
    net = PoseNet(**cfg)
    gen = torch.Generator().manual_seed(seed)
    init_params(net, gen)
    return net.to(dev).eval()


def knn_tensor(knn_idx, npoint: int, device) -> torch.Tensor:
    """A host-checked static (N, K) graph, or the multi-object variant's
    stacked (O, N, K) table of them (each row checked), as int32 on `device`."""
    knn = np.asarray(knn_idx)
    if knn.ndim == 3:
        return torch.as_tensor(np.stack([check_knn(row, npoint) for row in knn]),
                               device=device)
    return torch.as_tensor(check_knn(knn, npoint), device=device)
