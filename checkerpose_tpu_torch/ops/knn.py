"""Static KNN graph over the 3D keypoints (counterpart of
checkerpose_tpu/ops/knn.py: `knn_index` in numpy, `gather_graph_feature`
in torch)."""
from __future__ import annotations

import numpy as np
import torch


def knn_index(points, k: int) -> np.ndarray:
    """K nearest neighbors by squared euclidean distance; int32 (N, K).

    Ties go to the lower index (stable argsort), as torch.topk does on the
    reference's `-||xi-xj||^2` matrix; each row starts with the point itself.
    """
    pts = np.asarray(points, dtype=np.float64)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=-1, kind="stable")[:, :k]
    return idx.astype(np.int32)


def gather_graph_feature(x: torch.Tensor, knn_idx) -> torch.Tensor:
    """EdgeConv's edge features concat([x_j - x_i, x_i]) over each node's
    neighbours: x (B, N, C) channel-last, knn_idx a static (N, K) int graph
    -> (B, N, K, 2C). (The EdgeConv layers of the port never build this
    tensor: ops/edgeconv.py splits its weights instead.)"""
    xj = x[:, torch.as_tensor(knn_idx, device=x.device).long()]            # (B, N, K, C)
    xi = x[:, :, None, :].expand_as(xj)
    return torch.cat([xj - xi, xi], dim=-1)


def check_knn(knn_idx, npoint: int) -> np.ndarray:
    """Validate a static (N, K) graph on the host: int, 2-D, N rows, every
    entry in [0, N). The CUDA EdgeConv kernel reads neighbours unchecked."""
    knn = np.asarray(knn_idx)
    if knn.ndim != 2 or knn.shape[0] != npoint or not np.issubdtype(knn.dtype, np.integer):
        raise ValueError(f"knn_idx must be an int (N={npoint}, K) array, "
                         f"got {knn.dtype} {knn.shape}")
    if knn.size and (knn.min() < 0 or knn.max() >= npoint):
        raise ValueError(f"knn_idx entries must lie in [0, {npoint})")
    return knn.astype(np.int32)
