"""Geometry: projection, point-cloud normalization, bbox math and FPS on the
host (numpy), GT label generation on the device (counterpart of
checkerpose_tpu/ops/geometry.py).

The host bbox helpers keep the exact int truncation of the reference data
pipeline (`checkerpose/bop_dataset_pytorch.py:147-235`)."""
from __future__ import annotations

import numpy as np
import torch


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center a point cloud at its mean and scale it to the unit ball."""
    pc = np.asarray(pc)
    pc = pc - np.mean(pc, axis=0)
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
    return pc / m


def project_pts(pts, K, R, t):
    """Project 3D points: pts (N, 3), K (3, 3), R (3, 3), t (3,) or (3, 1).
    Returns (uv (N, 2), depth (N,)), numpy."""
    t = np.reshape(t, (3,))
    cam = pts @ R.T + t[None, :]
    proj = cam @ K.T
    return proj[:, :2] / proj[:, 2:3], cam[:, 2]


def padding_bbox(bbox, padding_ratio: float) -> np.ndarray:
    """Pad bbox (x, y, w, h) about its center, int-truncated."""
    x1, y1, bw, bh = float(bbox[0]), float(bbox[1]), float(bbox[2]), float(bbox[3])
    cx = x1 + 0.5 * bw
    cy = y1 + 0.5 * bh
    pw = int(bw * padding_ratio)
    ph = int(bh * padding_ratio)
    return np.array([int(cx - pw / 2), int(cy - ph / 2), pw, ph])


def aug_bbox(bbox, padding_ratio: float, rng: np.random.Generator) -> np.ndarray:
    """Randomly scale (+-25%) and shift (+-25%) a GT bbox, then pad; draws
    from `rng` in the JAX package's order."""
    x1, y1, bw, bh = float(bbox[0]), float(bbox[1]), float(bbox[2]), float(bbox[3])
    cx = x1 + 0.5 * bw
    cy = y1 + 0.5 * bh
    scale_ratio = 1 + 0.25 * (2 * rng.random() - 1)
    shift = 0.25 * (2 * rng.random(2) - 1)
    center = np.array([cx + bw * shift[0], cy + bh * shift[1]])
    aw = int(bw * scale_ratio * padding_ratio)
    ah = int(bh * scale_ratio * padding_ratio)
    return np.array([int(center[0] - aw / 2), int(center[1] - ah / 2), aw, ah])


def square_bbox(bbox) -> np.ndarray:
    """Expand bbox to a square about its center (int-truncated corners): the
    final bbox of `crop_square_resize` / `crop_resize_by_warp_affine`."""
    x1, y1, bw, bh = float(bbox[0]), float(bbox[1]), float(bbox[2]), float(bbox[3])
    x2, y2 = x1 + bw, y1 + bh
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    if bh > bw:
        x1, x2 = cx - bh / 2, cx + bh / 2
    else:
        y1, y2 = cy - bw / 2, cy + bw / 2
    x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
    return np.array([x1, y1, x2 - x1, y2 - y1])


def clip_bbox(bbox, max_x: int, max_y: int) -> np.ndarray:
    """The final bbox of plain `crop_resize`: bbox clipped to the image."""
    x1 = max(int(bbox[0]), 0)
    y1 = max(int(bbox[1]), 0)
    x2 = min(int(bbox[0] + bbox[2]), max_x)
    y2 = min(int(bbox[1] + bbox[3]), max_y)
    return np.array([x1, y1, x2 - x1, y2 - y1])


def final_bbox(bbox, resize_method: str, max_x: int, max_y: int) -> np.ndarray:
    if resize_method in ("crop_square_resize", "crop_resize_by_warp_affine"):
        return square_bbox(bbox)
    elif resize_method == "crop_resize":
        return clip_bbox(bbox, max_x, max_y)
    raise NotImplementedError(resize_method)


def farthest_point_sample(xyz: np.ndarray, npoint: int, init_center: bool = True) -> np.ndarray:
    """FPS over mesh vertices, indices (npoint,): seeded with the vertex
    closest to the cloud's bbox center (or vertex 0), then greedy max-min."""
    n = xyz.shape[0]
    dists = np.full(n, np.inf)
    idx = np.zeros(npoint, dtype=np.int64)
    if init_center:
        center = 0.5 * (xyz.max(axis=0) + xyz.min(axis=0))
        first = int(np.argmin(((xyz - center) ** 2).sum(axis=1)))
    else:
        first = 0
    idx[0] = first
    last = xyz[first]
    for i in range(1, npoint):
        d = ((xyz - last) ** 2).sum(axis=1)
        dists = np.minimum(dists, d)
        nxt = int(np.argmax(dists))
        idx[i] = nxt
        last = xyz[nxt]
    return idx


def roi_grid(crop_size_gt: int) -> np.ndarray:
    """(h, w, 2) f32 grid of the (x, y) pixel coordinates inside the GT crop
    (the reference's `bop_dataset_pytorch.py:265-269`)."""
    r = np.arange(crop_size_gt, dtype=np.float32)
    gx, gy = np.meshgrid(r, r)                  # both (h, w); gx varies along w
    return np.stack([gx, gy], axis=-1)


def map_crop_to_original(pixels, bbox, crop_size: int):
    """Crop-grid pixel coordinates (..., 2) -> original-image coordinates:
    bbox_wh / crop_size * pixel + bbox_xy (the reference's
    `bop_dataset_pytorch.py:223-235`). numpy arrays or tensors (then bbox a
    tensor too), any leading axes; bbox (4,) [x, y, w, h]."""
    if isinstance(pixels, torch.Tensor):
        ratio = torch.stack([bbox[2] / crop_size, bbox[3] / crop_size])
    else:
        ratio = np.array([bbox[2] / crop_size, bbox[3] / crop_size])
    return pixels * ratio + bbox[:2]


def crop_cell_sizes(bbox: torch.Tensor, crop_size_gt: int):
    """(px, py, degenerate), each (B, 1): the size in original-image pixels
    of one cell of the crop_size_gt grid over bbox (B, 4) [x, y, w, h]; a
    degenerate bbox (w <= 0 or h <= 0, the dummy of a failed sample) gets
    cell size 1, so nothing downstream divides by zero."""
    w, h = bbox[:, 2:3].float(), bbox[:, 3:4].float()
    degenerate = (w <= 0) | (h <= 0)
    one = torch.ones_like(w)
    return (torch.where(degenerate, one, w / crop_size_gt),
            torch.where(degenerate, one, h / crop_size_gt), degenerate)


def make_code_labels(proj_xy: torch.Tensor, bbox: torch.Tensor, crop_size_gt: int):
    """Discretize 2D keypoint projections into the binary-code labels,
    batched: proj_xy (B, N, 2) float in original-image pixels, bbox (B, 4)
    final square bbox [x, y, w, h], crop_size_gt static S.

    Returns (roi_bit (B, N) float32 {0., 1.}, x_id, y_id (B, N) int32 in
    [0, S-1]). Out of roi if a projection lies before the bbox origin or its
    truncated (toward zero, like numpy's `.astype(int)`) cell id is >= S;
    ids are clipped. A degenerate bbox gives roi_bit 0 and id 0, never NaN.
    """
    S = crop_size_gt
    px, py, degenerate = crop_cell_sizes(bbox, S)
    x_id = torch.trunc((proj_xy[..., 0] - bbox[:, 0:1]) / px).to(torch.int32)
    y_id = torch.trunc((proj_xy[..., 1] - bbox[:, 1:2]) / py).to(torch.int32)
    out1 = (proj_xy[..., 0] < bbox[:, 0:1]) | (proj_xy[..., 1] < bbox[:, 1:2])
    out2 = (x_id >= S) | (y_id >= S)
    roi_bit = (~(out1 | out2 | degenerate)).to(torch.float32)
    return roi_bit, x_id.clamp(0, S - 1), y_id.clamp(0, S - 1)
