"""Inputs made from the seed: keypoints and their graphs, poses, boxes,
crops and training labels. Both the program and the reference get them.

Keypoints are uniform in a 80 mm cube, centred and scaled to the unit ball
for the network (the FPS normalisation), with a K-nearest-neighbour graph
over the normalised points whose rows start with the point itself (ties to
the lower index). Poses put the object 350-500 mm in front of the LINEMOD
camera; the crop box is the square around the projected keypoints with a
margin, as a detector hands it over.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

CAM_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one use of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 63, *tags]))


def torch_seed(seed: int, tag: int) -> int:
    return int(rng_for(seed, tag).integers(0, 2 ** 62))


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    pc = pc - pc.mean(0)
    return pc / np.sqrt((pc ** 2).sum(1)).max()


def knn_index(points: np.ndarray, k: int) -> np.ndarray:
    pts = np.asarray(points, dtype=np.float64)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return np.argsort(d2, axis=-1, kind="stable")[:, :k].astype(np.int32)


def keypoints(rng: np.random.Generator, n_sets: int, npoint: int, k: int):
    """(p3d (S, N, 3) mm, p3d_normed (S, N, 3), knn (S, N, K) int32), f32."""
    p3d = rng.uniform(-40, 40, (n_sets, npoint, 3)).astype(np.float32)
    p3dn = np.stack([pc_normalize(p) for p in p3d]).astype(np.float32)
    knn = np.stack([knn_index(p, k) for p in p3dn])
    return p3d, p3dn, knn


def random_poses(rng: np.random.Generator, n: int, p3d: np.ndarray):
    """n random poses of the (N, 3) or (n, N, 3) keypoints: R (n, 3, 3),
    t (n, 3), their projections uv (n, N, 2) and square boxes (n, 4)."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    t = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                  rng.uniform(350, 500, n)], -1)
    pts = np.broadcast_to(p3d, (n, *p3d.shape[-2:]))
    cam = pts @ Q.transpose(0, 2, 1) + t[:, None]
    proj = cam @ CAM_K.T
    uv = proj[..., :2] / proj[..., 2:3]
    side = np.maximum(np.ptp(uv[..., 0], 1), np.ptp(uv[..., 1], 1)) * 1.4
    bbox = np.stack([uv[..., 0].min(1) - side * 0.15, uv[..., 1].min(1) - side * 0.15,
                     side, side], -1)
    return (Q.astype(np.float32), t.astype(np.float32), uv.astype(np.float32),
            bbox.astype(np.float32))


def device_crops(seed: int, n: int, device) -> torch.Tensor:
    """n (256, 256, 3) uint8 crops made on the device: uniform noise under a
    brightness (each channel's mean in [40, 215]) and a contrast ([0.2, 1])
    of each crop's own, so that crops differ as a network sees them (noise
    alone gives every crop nearly the same outputs)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, 256, 256, 3), dtype=torch.uint8, device=device)
    for a in range(0, n, 256):                       # in blocks: the float noise is 4x
        b = min(n, a + 256)
        noise = torch.rand((b - a, 256, 256, 3), generator=gen, device=device)
        mean = 40.0 + 175.0 * torch.rand((b - a, 1, 1, 3), generator=gen, device=device)
        amp = 0.2 + 0.8 * torch.rand((b - a, 1, 1, 1), generator=gen, device=device)
        out[a:b] = (mean + amp * (255.0 * noise - 127.5)).clamp(0, 255).to(torch.uint8)
    return out


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalised float32 NHWC."""
    mean = torch.tensor([0.485, 0.456, 0.406], device=img.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=img.device)
    return (img.float() / 255.0 - mean) / std


def masks(rng: np.random.Generator, n: int, size: int = 64) -> Dict[str, np.ndarray]:
    """Random visible and full masks (n, size, size) f32."""
    return {"mask_visib": (rng.random((n, size, size)) > 0.5).astype(np.float32),
            "mask_full": (rng.random((n, size, size)) > 0.3).astype(np.float32)}
