"""Plain reference of the decode and of what a pose answer claims, in
float64 on the device. Imports nothing but torch."""
from __future__ import annotations

import torch


def decode(x_id, y_id, bbox, S: int):
    """Cell ids (B, N) at S x S -> original-image pixels (B, N, 2): each id
    times the box's cell size, plus the box's corner."""
    bbox = bbox.double()
    ids = torch.stack([x_id, y_id], -1).double()
    return ids * (bbox[:, None, 2:4] / S) + bbox[:, None, 0:2]


def seg_at(seg_logits, x_id, y_id, S: int):
    """The seg map (B, h, w) read at each id's cell (B, N)."""
    h = seg_logits.shape[1]
    sx = torch.clamp(x_id.long() * h // S, 0, h - 1)
    sy = torch.clamp(y_id.long() * h // S, 0, h - 1)
    return seg_logits.reshape(seg_logits.shape[0], -1).gather(1, sy * h + sx)


def reproj_errors(R, t, p3d, p2d, K):
    """Pixel distance of each projected keypoint from its 2D point, float64
    (infinite for a point not in front of the camera): R (B, 3, 3), t (B, 3),
    p3d (B, N, 3), p2d (B, N, 2), K (B, 3, 3)."""
    cam = p3d.double() @ R.double().transpose(1, 2) + t.double()[:, None]
    proj = cam @ K.double().transpose(1, 2)
    uv = proj[..., :2] / proj[..., 2:3]
    err = torch.linalg.norm(uv - p2d.double(), dim=-1)
    # a point on or behind the camera's plane projects nowhere
    return torch.where(cam[..., 2] > 1e-6, err, torch.inf)


def pose_violations(R, t, inliers, num_inliers, success, valid, p3d, p2d, K,
                    thresh: float, tol: float):
    """What a served pose answer says that the data does not bear out, by
    kind, each (B,). A solved crop (success) claims: at least 4 valid points
    (`few_valid`); R a rotation (`not_rotation`); `inliers` the valid points
    whose reprojection error under (R, t) is below `thresh`, points within
    `tol` of it not judged (`wrong_in`, `wrong_out`); num_inliers their count
    (`count`). A failed crop claims the identity pose (`not_identity`)."""
    valid = valid > 0.5
    inl = inliers > 0.5
    err = reproj_errors(R, t, p3d, p2d, K)
    solved = success.bool()
    zero = torch.zeros(R.shape[0], dtype=torch.long, device=R.device)
    eye = torch.eye(3, dtype=torch.float64, device=R.device)
    Rd = R.double()
    ortho = (Rd.transpose(1, 2) @ Rd - eye).abs().amax((1, 2))
    det = torch.linalg.det(Rd)
    ident = (Rd - eye).abs().amax((1, 2)).eq(0) & t.double().abs().amax(-1).eq(0)
    return {
        "wrong_in": torch.where(solved, (inl & (~valid | (err > thresh + tol))).sum(-1), zero),
        "wrong_out": torch.where(solved, (~inl & valid & (err < thresh - tol)).sum(-1), zero),
        "count": (solved & (num_inliers.double() != inl.sum(-1).double())).long(),
        "few_valid": (solved & (valid.sum(-1) < 4)).long(),
        "not_rotation": (solved & ((ortho > 1e-3) | ((det - 1).abs() > 1e-3))).long(),
        "not_identity": (~solved & ~ident).long(),
    }
