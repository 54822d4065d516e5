"""Pose + segmentation metrics, batched on the device (counterpart of
checkerpose_tpu/eval/metrics.py).

ADD / ADI / re / te as bop_toolkit defines them (`pose_error.py:147-211`), the
PoseCNN AUC and the mask metrics. The JAX package forces true f32 matmuls
for these; here no metric multiplies through a matmul at all (each product
is written out as broadcast multiply-adds over the 3 coordinates), so
neither TF32 nor who set the precision flags first can touch a result:
  * ADD averages |(R_est - R_gt) p + (t_est - t_gt)|, which never forms the
    two camera-frame clouds and so loses nothing to cancellation;
  * ADI centres both clouds on the GT cloud's centroid before posing them
    (so no coordinate carries the ~400 mm camera distance), then takes, for
    each GT-posed point, the nearest estimate-posed point from coordinate
    differences (no |a|^2 - 2ab + |b|^2 expansion), in chunks of poses and
    of points so a batch of poses stays within a fixed memory budget.
"""
from __future__ import annotations

import numpy as np
import torch

# elements of one (poses, GT points, estimate points) distance block
_ADI_BLOCK = 1 << 26


def _apply(R, t, pts):
    """R (..., 3, 3) p + t (..., 3) for pts (V, 3) -> (..., V, 3)."""
    return (pts[..., None, :] * R[..., None, :, :]).sum(-1) + t[..., None, :]


def add_error(R_est, t_est, R_gt, t_gt, pts):
    """Average distance of model points under the two poses (mm), batched
    over leading dims of the poses."""
    return _apply(R_est - R_gt, t_est - t_gt, pts).norm(dim=-1).mean(-1)


def adi_error(R_est, t_est, R_gt, t_gt, pts):
    """Average closest-point distance for symmetric objects (mm): for each
    GT-posed point the distance to the nearest estimate-posed point. Poses
    (B, 3, 3) / (B, 3) or unbatched."""
    single = R_est.dim() == 2
    if single:
        R_est, t_est, R_gt, t_gt = R_est[None], t_est[None], R_gt[None], t_gt[None]
    # both clouds minus the GT cloud's centroid R_gt c + t_gt
    c = pts.mean(0)
    q = pts - c
    pe = _apply(R_est, _apply(R_est - R_gt, t_est - t_gt, c[None])[..., 0, :], q)  # (B, V, 3)
    pg = _apply(R_gt, torch.zeros_like(t_gt), q)
    B, V = pe.shape[:2]
    rows = max(1, min(V, _ADI_BLOCK // max(V, 1)))
    poses = max(1, _ADI_BLOCK // (rows * V))
    out = torch.empty(B, dtype=pe.dtype, device=pe.device)
    for b in range(0, B, poses):
        e = pe[b:b + poses, None]                                # (P, 1, V, 3)
        total = torch.zeros(e.shape[0], dtype=pe.dtype, device=pe.device)
        for r in range(0, V, rows):
            g = pg[b:b + poses, r:r + rows, None]                # (P, R, 1, 3)
            d2 = (g[..., 0] - e[..., 0]) ** 2
            d2 += (g[..., 1] - e[..., 1]) ** 2
            d2 += (g[..., 2] - e[..., 2]) ** 2
            total += d2.amin(-1).sqrt().sum(-1)
        out[b:b + poses] = total / V
    return out[0] if single else out


def re_error(R_est, R_gt):
    """Rotation error in degrees, batched over leading dims."""
    cos = ((R_est * R_gt).sum((-2, -1)) - 1.0) * 0.5
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def te_error(t_est, t_gt):
    """Translation error, batched over leading dims."""
    return (t_est - t_gt).norm(dim=-1)


def _compose(R, S):
    """R (..., 3, 3) @ S (K, 3, 3) -> (..., K, 3, 3), as multiply-adds."""
    return (R[..., None, :, :, None] * S[:, None, :, :]).sum(-2)


def symmetry_transformations(model_info: dict, max_sym_disc_step: float = 0.01):
    """Discrete + sampled-continuous symmetry transforms from models_info, as
    bop_toolkit's misc.get_symmetry_transformations; list of (R, t) numpy."""
    syms = [(np.eye(3), np.zeros(3))]
    for sd in model_info.get("symmetries_discrete", []):
        M = np.array(sd, np.float64).reshape(4, 4)
        syms.append((M[:3, :3], M[:3, 3]))
    for sc in model_info.get("symmetries_continuous", []):
        axis = np.array(sc["axis"], np.float64)
        offset = np.array(sc.get("offset", [0, 0, 0]), np.float64)
        n = max(int(np.ceil(np.pi / max_sym_disc_step)), 1)
        for i in range(1, n + 1):
            ang = 2 * np.pi * i / (n + 1)
            k = axis / np.linalg.norm(axis)
            Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)
            syms.append((R, offset - R @ offset))
    return syms


def closest_symmetric_rot_error(R_est, R_gt, sym_Rs):
    """min over symmetries S of re(R_est, R_gt S), unbatched."""
    R_est = torch.as_tensor(R_est, dtype=torch.float32)
    R_gt = torch.as_tensor(R_gt, dtype=torch.float32)
    S = torch.as_tensor(np.asarray(sym_Rs), dtype=torch.float32, device=R_gt.device)
    return re_error(R_est[None], _compose(R_gt, S)).min()


def compute_auc_posecnn(errors: np.ndarray) -> float:
    """PoseCNN-style ADD AUC with a 0.1 m cutoff (numpy); `errors` in meters."""
    d = np.sort(np.asarray(errors, np.float64).copy())
    d[d > 0.1] = np.inf
    accuracy = np.cumsum(np.ones(d.shape[0])) / max(d.shape[0], 1)
    ids = np.isfinite(d)
    if d.shape[0] == 0 or ids.sum() == 0:
        return float("nan")
    rec = d[ids]
    prec = accuracy[ids]
    mrec = np.concatenate(([0], rec, [0.1]))
    mpre = np.concatenate(([0], prec, [prec[-1]]))
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(((mrec[idx] - mrec[idx - 1]) * mpre[idx]).sum() * 10)


def mask_metrics(pred: np.ndarray, gt: np.ndarray):
    """(pixelwise error, IoU) of one mask pair (numpy); empty union -> IoU 1."""
    err = float(np.mean(np.abs(pred - gt)))
    inter = np.logical_and(pred > 0.5, gt > 0.5).sum()
    union = np.logical_or(pred > 0.5, gt > 0.5).sum()
    iou = 1.0 if union < 1 else float(inter / union)
    return err, iou


def batched_mask_metrics(pred: torch.Tensor, gt: torch.Tensor):
    """`mask_metrics` over a batch (B, h, w) on the device: (err, iou), (B,)."""
    pred, gt = pred.float(), gt.float()
    err = (pred - gt).abs().mean((1, 2))
    p, g = pred > 0.5, gt > 0.5
    inter = (p & g).sum((1, 2)).float()
    union = (p | g).sum((1, 2)).float()
    iou = torch.where(union < 1, torch.ones_like(union), inter / union.clamp_min(1.0))
    return err, iou


def batched_pose_errors(R_est, t_est, R_gt, t_gt, pts, use_adi: bool = False,
                        sym_rots=None):
    """(B,) ADD or ADI + re + te for a batch of poses against shared pts
    (V, 3). sym_rots: optional (K, 3, 3) discrete symmetry rotations (the
    identity included); re is then taken against the closest symmetric GT."""
    R_est, t_est = R_est.float(), t_est.float()
    R_gt, t_gt, pts = R_gt.float(), t_gt.float(), pts.float()
    adx = (adi_error if use_adi else add_error)(R_est, t_est, R_gt, t_gt, pts)
    if sym_rots is None:
        re = re_error(R_est, R_gt)
    else:
        S = torch.as_tensor(sym_rots, dtype=torch.float32, device=R_gt.device)
        re = re_error(R_est[:, None], _compose(R_gt, S)).amin(-1)
    return {"adx": adx, "re": re, "te": te_error(t_est, t_gt)}


def rete_pass_rates(re_deg: np.ndarray, te_mm: np.ndarray) -> dict:
    """Rotation/translation pass rates: rete2 = re < 2 deg AND te < 20 mm,
    rete5 = re < 5 deg AND te < 50 mm, and the single rates. Failed solves
    carry re = 180, te = inf and fail every threshold."""
    re_deg = np.asarray(re_deg, np.float64)
    te_mm = np.asarray(te_mm, np.float64)
    return {
        "rete2": float(((re_deg < 2.0) & (te_mm < 20.0)).mean()),
        "rete5": float(((re_deg < 5.0) & (te_mm < 50.0)).mean()),
        "re2": float((re_deg < 2.0).mean()),
        "re5": float((re_deg < 5.0).mean()),
        "te2": float((te_mm < 20.0).mean()),
        "te5": float((te_mm < 50.0).mean()),
    }

