"""Point-cloud helper on the host and GT label generation on the device
(counterparts of checkerpose_tpu/ops/geometry.py::pc_normalize and
::make_code_labels)."""
from __future__ import annotations

import numpy as np
import torch


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center a point cloud at its mean and scale it to the unit ball."""
    pc = np.asarray(pc)
    pc = pc - np.mean(pc, axis=0)
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
    return pc / m


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
