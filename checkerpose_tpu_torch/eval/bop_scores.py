"""BOP19 pose-error metrics and average-recall scoring (counterpart of
checkerpose_tpu/eval/bop_scores.py).

The scoring pipeline the reference delegates to bop_toolkit
(`eval_bop19_pose.py` -> `eval_calc_errors.py` -> `eval_calc_scores.py`):

  * MSSD: Maximum Symmetry-aware Surface Distance
      e = min_sym max_vertex || (R_est x + t_est) - (R_gt (R_sym x + t_sym) + t_gt) ||
  * MSPD: Maximum Symmetry-aware Projection Distance (pixels), the same
      min / max over projected vertices;
  * VSD: Visible Surface Discrepancy over depth maps rendered on the host
      (eval/renderer.py);
  * BOP19 recall thresholds: MSSD theta in (0.05..0.50) * diameter,
      MSPD theta in (5..50) * w/640 px; AR = mean recall over thresholds.

MSSD and MSPD run batched on the device in f32, chunked over pairs so that
the (pairs, symmetries, vertices, 3) intermediates stay within a fixed
budget. No product goes through a matmul (each is written as multiply-adds
over the 3 coordinates, as eval/metrics.py does), so TF32 cannot touch them
whoever set the flags; MSSD takes the difference of the two posed clouds as
(R_est - R_gt S) x + (t_est - t_gt S), so no coordinate carries the camera
distance. The matching, recall, VSD and CSV parts are numpy on the host.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.eval.metrics import _apply, _compose, symmetry_transformations
from checkerpose_tpu_torch.eval.renderer import render_depth

MSSD_THRESHOLDS = np.arange(0.05, 0.51, 0.05)           # * diameter
MSPD_THRESHOLDS = np.arange(5.0, 51.0, 5.0)             # * w/640 px

# elements of the (pairs, symmetries, vertices) x 3 coordinates of one chunk: 256 MB of f32
_PAIR_BLOCK = 1 << 26


def _sym_gt(R_gt, t_gt, sym_R, sym_t):
    """GT poses composed with every symmetry: R_gt S_R (..., S, 3, 3) and
    R_gt S_t + t_gt (..., S, 3)."""
    return _compose(R_gt, sym_R), _apply(R_gt, t_gt, sym_t)


def _posed(R, t, pts):
    """The three coordinates (each (..., V)) of R (..., 3, 3) p + t (..., 3)
    for pts (V, 3), as multiply-adds with no (..., V, 3, 3) intermediate."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return [R[..., i, 0, None] * x + R[..., i, 1, None] * y + R[..., i, 2, None] * z
            + t[..., i, None] for i in range(3)]


def _project(R, t, K, pts):
    """Pixel coordinates (u, v), each (..., V), of pts (V, 3) under poses R
    (..., 3, 3), t (..., 3) and intrinsics K (..., 3, 3); depth clamped at 1e-6."""
    cx_, cy_, cz_ = _posed(R, t, pts)
    z = cz_.clamp_min(1e-6)
    return (K[..., 0, 0, None] * cx_ / z + K[..., 0, 2, None],
            K[..., 1, 1, None] * cy_ / z + K[..., 1, 2, None])


def mssd(R_est, t_est, R_gt, t_gt, pts, sym_R, sym_t):
    """Max surface distance minimised over symmetry transforms, batched over
    the poses' leading dims. pts (V, 3); sym_R (S, 3, 3), sym_t (S, 3) with
    the identity first."""
    Rg, tg = _sym_gt(R_gt, t_gt, sym_R, sym_t)
    d = _posed(R_est[..., None, :, :] - Rg, t_est[..., None, :] - tg, pts)    # 3 x (..., S, V)
    return (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).sqrt().amax(-1).amin(-1)


def mspd(R_est, t_est, R_gt, t_gt, K, pts, sym_R, sym_t):
    """Max projected distance (px) minimised over symmetry transforms,
    batched over the poses' leading dims."""
    Rg, tg = _sym_gt(R_gt, t_gt, sym_R, sym_t)
    ue, ve = _project(R_est, t_est, K, pts)                                  # (..., V)
    ug, vg = _project(Rg, tg, K[..., None, :, :], pts)                       # (..., S, V)
    du, dv = ue[..., None, :] - ug, ve[..., None, :] - vg
    return (du * du + dv * dv).sqrt().amax(-1).amin(-1)


def _as_f32(x, dev):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=dev)


def batched_bop_errors(R_est, t_est, R_gt, t_gt, K, pts, sym_R, sym_t, device="cuda"):
    """{"mssd": (P,), "mspd": (P,)} f32 tensors for P (estimate, GT) pairs
    against shared pts (V, 3) and symmetries (S, ...). Tensors stay on their
    device; numpy inputs go to `device`."""
    dev = R_est.device if isinstance(R_est, torch.Tensor) else resolve_device(device)
    R_est, t_est, R_gt, t_gt, K, pts, sym_R, sym_t = (
        _as_f32(a, dev) for a in (R_est, t_est, R_gt, t_gt, K, pts, sym_R, sym_t))
    P, S, V = R_est.shape[0], sym_R.shape[0], pts.shape[0]
    step = max(1, _PAIR_BLOCK // max(1, 3 * S * V))
    out = {"mssd": torch.empty(P, device=dev), "mspd": torch.empty(P, device=dev)}
    for a in range(0, P, step):
        sl = slice(a, a + step)
        out["mssd"][sl] = mssd(R_est[sl], t_est[sl], R_gt[sl], t_gt[sl], pts, sym_R, sym_t)
        out["mspd"][sl] = mspd(R_est[sl], t_est[sl], R_gt[sl], t_gt[sl], K[sl], pts,
                               sym_R, sym_t)
    return out


def bop19_average_recall(mssd_errs: np.ndarray, mspd_errs: np.ndarray,
                         diameter: float, im_width: int = 640):
    """BOP19-style AR over the MSSD and MSPD threshold grids (VSD excluded),
    one estimate per GT. Errors of failed estimates should be +inf."""
    mssd_errs = np.asarray(mssd_errs)
    mspd_errs = np.asarray(mspd_errs)
    ar_mssd = float(np.mean([(mssd_errs < th * diameter).mean()
                             for th in MSSD_THRESHOLDS]))
    scale = im_width / 640.0
    ar_mspd = float(np.mean([(mspd_errs < th * scale).mean()
                             for th in MSPD_THRESHOLDS]))
    return {"ar_mssd": ar_mssd, "ar_mspd": ar_mspd,
            "ar": 0.5 * (ar_mssd + ar_mspd)}


VSD_TAUS = np.arange(0.05, 0.51, 0.05)                   # * diameter (bop19)
VSD_DELTA = 15.0                                         # mm (bop19)


def depth_to_dist(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Depth (z) image -> euclidean distance image
    (misc.depth_im_to_dist_im_fast semantics)."""
    h, w = depth.shape
    us = (np.arange(w) - K[0, 2]) / K[0, 0]
    vs = (np.arange(h) - K[1, 2]) / K[1, 1]
    scale = np.sqrt(us[None, :] ** 2 + vs[:, None] ** 2 + 1.0)
    return depth.astype(np.float32) * scale.astype(np.float32)


def _visib_mask(d_test, d_model, delta):
    """bop19 visibility: visible where the model is in front of (or within
    delta of) the scene, or where the scene has no depth
    (bop_toolkit_lib/visibility.py:35-38)."""
    d_diff = d_model - d_test
    return np.logical_and(np.logical_or(d_diff <= delta, d_test == 0),
                          d_model > 0)


def vsd_error(R_est, t_est, R_gt, t_gt, depth_test, K, verts, faces,
              diameter: float, delta: float = VSD_DELTA, taus=VSD_TAUS,
              cost_type: str = "step",
              normalized_by_diameter: bool = True, render_cache=None,
              est_key=None, gt_key=None):
    """Visible Surface Discrepancy (Hodan et al., ECCV'18), the
    `pose_error.vsd` recipe over eval/renderer.py's depth maps. Returns one
    error per tau.

    render_cache / est_key / gt_key: an optional cache of rendered distance
    maps keyed per pose, owned by the caller. Matching is many-to-many (every
    estimate against every GT instance), so the cache turns 2*E*G renders of
    an image into E+G. The test depth's distance map is cached under
    ("test", id(depth_test)).
    """
    h, w = depth_test.shape

    def dist_of(R, t, ck):
        if render_cache is not None and ck is not None and ck in render_cache:
            return render_cache[ck]
        d = depth_to_dist(render_depth(verts, faces, R, t, K, w, h), K)
        if render_cache is not None and ck is not None:
            render_cache[ck] = d
        return d

    dist_est = dist_of(R_est, t_est, est_key)
    dist_gt = dist_of(R_gt, t_gt, gt_key)
    tk = ("test", id(depth_test))
    if render_cache is not None and tk in render_cache:
        dist_test = render_cache[tk]
    else:
        dist_test = depth_to_dist(depth_test, K)
        if render_cache is not None:
            render_cache[tk] = dist_test

    visib_gt = _visib_mask(dist_test, dist_gt, delta)
    visib_est = _visib_mask(dist_test, dist_est, delta)
    # the estimate is also visible wherever the GT is
    # (visibility.py:estimate_visib_mask_est; depth 0 <=> distance 0, so the
    # rendered distance map carries the same support)
    visib_est = np.logical_or(visib_est, np.logical_and(visib_gt, dist_est > 0))

    inter = np.logical_and(visib_gt, visib_est)
    union = np.logical_or(visib_gt, visib_est)
    union_count = int(union.sum())
    comp_count = union_count - int(inter.sum())
    if union_count == 0:
        return [1.0] * len(list(taus))
    dists = np.abs(dist_gt[inter] - dist_est[inter])
    if normalized_by_diameter:
        dists = dists / diameter
    errors = []
    for tau in taus:
        if cost_type == "step":
            costs = (dists >= tau).sum()
        elif cost_type == "tlinear":
            costs = np.clip(dists / tau, None, 1.0).sum()
        else:
            raise ValueError(cost_type)
        errors.append(float((costs + comp_count) / union_count))
    return errors


def match_poses_greedy(ests, error_th: float, max_ests: int, gt_valid):
    """Official greedy estimate <-> GT matching for ONE (scene, im, obj)
    group (bop_toolkit_lib/pose_matching.py:match_poses).

    ests: list of {"score": float, "errors": {gt_id: err}}, matched in
    decreasing score, each estimate and GT used at most once, only valid
    GTs, err < error_th. max_ests <= 0 means all. Returns [(est_index, gt_id)].
    """
    order = sorted(range(len(ests)), key=lambda i: ests[i]["score"], reverse=True)
    if max_ests > 0:
        order = order[:max_ests]
    matched_gt = set()
    matches = []
    for i in order:
        best_gt, best_err = -1, error_th
        for gt_id, err in ests[i]["errors"].items():
            if gt_id in matched_gt or not gt_valid[gt_id]:
                continue
            if err < best_err:
                best_gt, best_err = gt_id, err
        if best_gt >= 0:
            matched_gt.add(best_gt)
            matches.append((i, best_gt))
    return matches


def official_average_recall(groups, thresholds) -> float:
    """BOP19 6D-localization AR with official matching semantics
    (eval_calc_scores.py:261-275 + score.calc_localization_scores).

    groups: one per (scene_id, im_id, obj_id):
      {"ests": [{"score", "errors": {gt_id: normalized_err}}],
       "gt_valid": [bool per GT instance of this object in this image],
       "n_top": int}   # inst_count from the targets file; <= 0 = all
    Recall per threshold = matched valid GTs / valid GT instances; AR = the
    mean over thresholds.
    """
    recalls = []
    for th in thresholds:
        tp, tars = 0, 0
        for g in groups:
            n_valid = int(np.sum(g["gt_valid"]))
            n_top = g.get("n_top", 0)
            tars += min(n_top, n_valid) if n_top > 0 else n_valid
            tp += len(match_poses_greedy(g["ests"], float(th),
                                         g.get("n_top", 0), g["gt_valid"]))
        recalls.append(tp / max(tars, 1))
    return float(np.mean(recalls))


def sym_arrays(model_info: dict, max_sym_disc_step: float = 0.01,
               max_syms: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """(S, 3, 3), (S, 3) f32 symmetry arrays (identity first) from a
    models_info entry, capped at max_syms by uniform subsampling."""
    syms = symmetry_transformations(model_info, max_sym_disc_step)
    if len(syms) > max_syms:
        idx = np.linspace(0, len(syms) - 1, max_syms).astype(int)
        idx[0] = 0
        syms = [syms[i] for i in idx]
    R = np.stack([s[0] for s in syms]).astype(np.float32)
    t = np.stack([s[1] for s in syms]).astype(np.float32)
    return R, t


def check_bop_results_csv(path: str) -> List[str]:
    """Problems of a BOP19 result CSV (bop_toolkit_lib/inout.py:296,
    `check_results_bop19`); an empty list means it is well formed."""
    problems = []
    with open(path) as f:
        header = f.readline().strip()
        if header != "scene_id,im_id,obj_id,score,R,t,time":
            problems.append(f"bad header: {header}")
        for ln, line in enumerate(f, start=2):
            parts = line.strip().split(",")
            if len(parts) != 7:
                problems.append(f"line {ln}: {len(parts)} fields")
                continue
            try:
                int(parts[0]); int(parts[1]); int(parts[2]); float(parts[3])  # noqa: E702
                R = [float(x) for x in parts[4].split()]
                t = [float(x) for x in parts[5].split()]
                float(parts[6])
                if len(R) != 9:
                    problems.append(f"line {ln}: R has {len(R)} values")
                if len(t) != 3:
                    problems.append(f"line {ln}: t has {len(t)} values")
            except ValueError as e:
                problems.append(f"line {ln}: {e}")
    return problems


def load_bop_results_csv(path: str):
    """A BOP19 CSV as a list of dicts (inout.load_bop_results); lines
    without 7 fields are skipped."""
    out = []
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.strip().split(",")
            if len(p) != 7:
                continue
            out.append({
                "scene_id": int(p[0]), "im_id": int(p[1]), "obj_id": int(p[2]),
                "score": float(p[3]),
                "R": np.array([float(x) for x in p[4].split()]).reshape(3, 3),
                "t": np.array([float(x) for x in p[5].split()]),
                "time": float(p[6]),
            })
    return out
