"""High-level serving API: crops -> poses on the card (counterpart of
checkerpose_tpu/serving.py::ServingPipeline).

    net = make_posenet(npoint=512, backbone_name="hrnet_w18", num_graph_module=3)
    pipe = ServingPipeline(net, knn, p3d_xyz, p3d_normed)        # device="cuda"
    out = pipe(images_u8, bboxes, cam_K, generator)              # R, t, inliers

The network forward + decode run first, then the batched RANSAC-EPnP; both
are queued on the current CUDA stream without a host sync. Every EdgeConv
runs the fused CUDA kernel (ops/edgeconv.py).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.eval.decode import (adaptive_ids, ids_to_correspondences,
                                               soft_ids)
from checkerpose_tpu_torch.models.posenet import knn_tensor
from checkerpose_tpu_torch.ops.crop import normalize_image
from checkerpose_tpu_torch.solver.ransac import FAST_PROFILE, ransac_pnp
from checkerpose_tpu_torch.utils.logging import span

_DECODE_MODES = ("hard", "soft", "adaptive")


class ServingPipeline:
    def __init__(self, net, knn_idx, p3d_xyz, p3d_normed, *,
                 stage: Optional[int] = None, num_hyp: Optional[int] = None,
                 reproj_thresh: float = 2.0, soft_inlier_sigma: float = 0.0,
                 coherence_weight: float = 0.0, check_seg: bool = True,
                 discard_bd_pixel: int = 0, solver_kw: Optional[dict] = None,
                 decode_mode: str = "hard", decode_conf_tau: float = 3.0,
                 device="cuda"):
        if decode_mode not in _DECODE_MODES:
            raise ValueError(f"decode_mode must be one of {_DECODE_MODES}, got {decode_mode!r}")
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.knn = knn_tensor(knn_idx, net.npoint, self.device)
        self.stage = stage if stage is not None else net.num_refine_steps
        self.res = 2 ** net.output_res_log2(self.stage)
        self.p3d = torch.as_tensor(np.asarray(p3d_xyz), dtype=torch.float32, device=self.device)
        self.p3dn = torch.as_tensor(np.asarray(p3d_normed), dtype=torch.float32,
                                    device=self.device)
        self.solver_kw = dict(FAST_PROFILE)
        if num_hyp is not None:
            self.solver_kw["num_hyp"] = num_hyp
        if solver_kw:
            self.solver_kw.update(solver_kw)
        self.solver_kw.update(reproj_thresh=reproj_thresh,
                              soft_inlier_sigma=soft_inlier_sigma,
                              coherence_weight=coherence_weight)
        self.check_seg = check_seg
        self.discard_bd_pixel = discard_bd_pixel
        self.decode_mode = decode_mode
        self.decode_conf_tau = decode_conf_tau

    def correspondences(self, images_u8, bboxes):
        """Network forward + decode: (p2d (B, N, 2), valid (B, N))."""
        imgs = normalize_image(images_u8)
        B = imgs.shape[0]
        out = self.net(imgs, self.knn, self.p3dn.expand(B, *self.p3dn.shape),
                       stage=self.stage)
        with span("decode", imgs.device):
            roi = (out["roi_logit"][..., 0] > 0.0).float()
            seg = torch.sigmoid(out["seg_logits"][..., 0]) if self.check_seg else None
            if self.decode_mode == "soft":
                dec_x, dec_y = soft_ids(out["x_logits"], out["y_logits"])
            elif self.decode_mode == "adaptive":
                dec_x, dec_y = adaptive_ids(out["x_logits"], out["y_logits"],
                                            self.decode_conf_tau)
            else:
                dec_x, dec_y = out["x_id"], out["y_id"]
            return ids_to_correspondences(
                dec_x, dec_y, roi, bboxes, crop_size_gt=self.res, seg_mask=seg,
                check_seg=self.check_seg, discard_bd_pixel=self.discard_bd_pixel,
                filter_x_id=out["x_id"], filter_y_id=out["y_id"])

    def __call__(self, images_u8, bboxes, cam_K, generator: torch.Generator):
        """images_u8 (B, 256, 256, 3) uint8; bboxes (B, 4) final square crops;
        cam_K (3, 3) or (B, 3, 3); generator on the pipeline's device.
        Returns dict of tensors on the device: R (B, 3, 3), t (B, 3),
        inliers (B, N), num_inliers (B,), success (B,)."""
        dev = self.device
        with torch.inference_mode(), span("serving.call", dev):
            images_u8 = torch.as_tensor(images_u8, device=dev)
            bboxes = torch.as_tensor(bboxes, dtype=torch.float32, device=dev)
            B = images_u8.shape[0]
            K = torch.as_tensor(cam_K, dtype=torch.float32, device=dev)
            if K.dim() == 2:
                K = K.expand(B, 3, 3)
            p2d, valid = self.correspondences(images_u8, bboxes)
            return ransac_pnp(self.p3d.expand(B, *self.p3d.shape), p2d, valid, K,
                              generator, **self.solver_kw)

    def stream(self, batches, generator: torch.Generator, depth: int = 2):
        """Keep up to `depth` batches queued on the card: batch i's poses are
        copied to the host only after batch i+depth has been queued. Yields
        dicts of numpy arrays, in order."""
        pending = deque()
        for images_u8, bboxes, cam_K in batches:
            pending.append(self(images_u8, bboxes, cam_K, generator))
            if len(pending) > depth:
                yield self._to_host(pending.popleft())
        while pending:
            yield self._to_host(pending.popleft())

    def _to_host(self, out):
        with span("serving.to_host", self.device):
            return {k: v.cpu().numpy() for k, v in out.items()}
