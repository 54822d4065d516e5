"""Batched RANSAC-PnP on the card (counterpart of
checkerpose_tpu/solver/ransac.py).

The JAX package vmaps a per-image `ransac_pnp`; here the batch dimension is
written out: every tensor carries a leading B. A fixed-size hypothesis batch
is solved and scored in parallel, then the best model is polished by
weighted Gauss-Newton on its inliers. Hypotheses are index sets sampled by
Gumbel top-k from a torch.Generator; a caller may pass them instead
(`hyp_idx`), which is how the tests feed the JAX package's own indices.

After the sampling, `solver_route` picks one of two paths for the same
algorithm: "fused", the hand-written kernel of csrc/ransac.cu (two launches,
solver/fused.py), for CUDA tensors within its limits; "eager", the chain of
PyTorch operations below, for the rest and on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.solver import fused
from checkerpose_tpu_torch.solver.epnp import epnp, refine_pose_gn, reproj_errors
from checkerpose_tpu_torch.utils.logging import span

# low-latency serving profile (same values as the JAX package's FAST_PROFILE)
FAST_PROFILE = dict(num_hyp=64, refine_iters=5, reseed=False, n_backtrack=2)


def sample_hypotheses(valid: torch.Tensor, num_hyp: int, sample_size: int,
                      generator: torch.Generator) -> torch.Tensor:
    """(B, num_hyp, sample_size) int64 index sets from the valid points, by
    Gumbel top-k over masked logits (invalid points only when fewer than
    sample_size are valid)."""
    B, N = valid.shape
    logits = torch.where(valid > 0.5, 0.0, -1e9)
    u = torch.rand((B, num_hyp, N), generator=generator, device=valid.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    return torch.topk(logits[:, None] + g, sample_size, dim=-1).indices


def solver_route(device, N: int, sample_size: int) -> str:
    """Which path solves a call of N points a row and hypotheses of
    sample_size points on `device`: "fused" (the kernel of csrc/ransac.cu,
    solver/fused.py) for a CUDA device with 1 <= N <= fused.MAX_N and 1 <=
    sample_size <= fused.MAX_SAMPLE, "eager" (the PyTorch chain below)
    otherwise, every CPU call included. Pure Python: no card needed."""
    if (torch.device(device).type == "cuda" and 1 <= N <= fused.MAX_N
            and 1 <= sample_size <= fused.MAX_SAMPLE):
        return "fused"
    return "eager"


def ransac_pnp(p3d, p2d, valid, K, generator: Optional[torch.Generator] = None, *,
               num_hyp: int = 128, sample_size: int = 6, reproj_thresh: float = 2.0,
               refine_iters: int = 8, irls_rounds: int = 2,
               soft_inlier_sigma: float = 0.0, coherence_weight: float = 0.0,
               neighborhood_radius: float = 20.0, reseed: bool = True,
               n_backtrack: int = 3, hyp_idx: Optional[torch.Tensor] = None):
    """Robust poses from 2D-3D correspondences, batched.

    p3d (B, N, 3); p2d (B, N, 2); valid (B, N) {0,1}; K (B, 3, 3);
    hyp_idx (B, H, S) or None to sample num_hyp sets of sample_size with
    `generator`. soft_inlier_sigma > 0 scores inliers by a sigmoid;
    coherence_weight > 0 adds the mean-field Potts smoothing over the 2D
    neighbourhood graph (see the JAX module's docstring).

    Returns dict(R (B,3,3), t (B,3), inliers (B,N), num_inliers (B,),
    success (B,) bool); a failed solve (fewer than 4 valid points or a
    non-finite pose) returns the identity pose.

    `solver_route` picks the path from the device and the shapes; both run
    the same algorithm on the same index sets. `ransac_pnp.launches_by_route`
    counts the two stages (hypotheses, refine) each route ran, two a call
    either way: a kernel launch each on "fused", a chain of PyTorch
    operations each on "eager" (`fused.launches_by_route`, zeroed by
    `utils/counters.py::reset_launch_counts`).
    """
    with span("solver", p2d.device):
        with span("solver.hypotheses", p2d.device):
            if hyp_idx is None:
                if generator is None:
                    raise ValueError("ransac_pnp needs a generator or hyp_idx")
                hyp_idx = sample_hypotheses(valid, num_hyp, sample_size, generator)
            route = solver_route(p2d.device, p2d.shape[1], hyp_idx.shape[-1])
            if route == "fused":
                pose0, _ = fused.hypotheses(p3d, p2d, valid, K, hyp_idx, reproj_thresh,
                                            soft_inlier_sigma)
            else:
                R0, t0, _ = eager_hypotheses(p3d, p2d, valid, K, hyp_idx, reproj_thresh,
                                             soft_inlier_sigma)

        with span("solver.refine", p2d.device):
            kw = dict(reproj_thresh=reproj_thresh, refine_iters=refine_iters,
                      irls_rounds=irls_rounds, soft_inlier_sigma=soft_inlier_sigma,
                      coherence_weight=coherence_weight,
                      neighborhood_radius=neighborhood_radius, reseed=reseed,
                      n_backtrack=n_backtrack)
            if route == "fused":
                return fused.refine(p3d, p2d, valid, K, pose0, **kw)
            return _eager_refine(p3d, p2d, valid, K, R0, t0, **kw)


ransac_pnp.launches_by_route = fused.launches_by_route


def eager_hypotheses(p3d, p2d, valid, K, hyp_idx, reproj_thresh: float,
                     soft_inlier_sigma: float):
    """The eager chain's best hypothesis of each row: (R0 (B, 3, 3), t0 (B,
    3), its index (B,))."""
    fused.launches_by_route["eager"] += 1
    B = p2d.shape[0]
    idx = hyp_idx.long()
    bi = torch.arange(B, device=p2d.device)
    h3d = p3d[bi[:, None, None], idx]                              # (B, H, S, 3)
    h2d = p2d[bi[:, None, None], idx]
    hw = valid[bi[:, None, None], idx]

    Rs, ts = epnp(h3d, h2d, K[:, None], hw, use_eigh=False)       # (B, H, ...)
    errs = reproj_errors(Rs, ts, p3d[:, None], p2d[:, None], K[:, None])  # (B,H,N)
    if soft_inlier_sigma > 0:
        scores = (torch.sigmoid((reproj_thresh - errs) / soft_inlier_sigma)
                  * valid[:, None]).sum(-1)
    else:
        scores = ((errs < reproj_thresh).float() * valid[:, None]).sum(-1)
    best = scores.argmax(-1)
    return Rs[bi, best], ts[bi, best], best


def _eager_refine(p3d, p2d, valid, K, R0, t0, *, reproj_thresh, refine_iters, irls_rounds,
                  soft_inlier_sigma, coherence_weight, neighborhood_radius, reseed,
                  n_backtrack):
    """The eager chain's IRLS refine from (R0, t0): ransac_pnp's answer."""
    fused.launches_by_route["eager"] += 1
    B = p2d.shape[0]
    n_valid = valid.sum(-1)
    if coherence_weight > 0:
        d2 = ((p2d[:, :, None] - p2d[:, None]) ** 2).sum(-1)
        adj = ((d2 < neighborhood_radius ** 2) & (d2 > 0)).float()
        adj = adj * valid[:, None] * valid[:, :, None]
        adj_rownorm = adj / torch.clamp_min(adj.sum(-1, keepdim=True), 1.0)

    def inlier_w(R, t):
        e = reproj_errors(R, t, p3d, p2d, K)
        if soft_inlier_sigma > 0:
            w = torch.sigmoid((reproj_thresh - e) / soft_inlier_sigma) * valid
        else:
            w = (e < reproj_thresh).float() * valid
        if coherence_weight > 0:
            sig = soft_inlier_sigma if soft_inlier_sigma > 0 else 0.25
            logit = (reproj_thresh - e) / sig
            consensus = (adj_rownorm
                         @ (torch.sigmoid(logit) * valid)[..., None])[..., 0]
            kappa = 10.0 * coherence_weight
            w = torch.sigmoid(logit + kappa * (2.0 * consensus - 1.0)) * valid
        return torch.where((w.sum(-1) >= 4)[:, None], w, valid)

    def werr(R, t, w):
        return (reproj_errors(R, t, p3d, p2d, K) * w).sum(-1) / (w.sum(-1) + 1e-9)

    def keep_better(R, t, Rc, tc, w):
        better = werr(Rc, tc, w) < werr(R, t, w)
        return (torch.where(better[:, None, None], Rc, R),
                torch.where(better[:, None], tc, t))

    eye = torch.eye(3, device=p2d.device).expand(B, 3, 3)
    if irls_rounds <= 0:
        inliers = (reproj_errors(R0, t0, p3d, p2d, K) < reproj_thresh).float() * valid
        success = n_valid >= 4
        return {"R": torch.where(success[:, None, None], R0, eye),
                "t": torch.where(success[:, None], t0, 0.0),
                "inliers": inliers, "num_inliers": inliers.sum(-1), "success": success}

    gn = dict(iters=refine_iters, n_backtrack=n_backtrack)
    w = inlier_w(R0, t0)
    Rc, tc = refine_pose_gn(R0, t0, p3d, p2d, K, w, **gn)
    if reseed:
        R2, t2 = epnp(p3d, p2d, K, w)
        R2, t2 = refine_pose_gn(R2, t2, p3d, p2d, K, w, **gn)
        use2 = werr(R2, t2, w) < werr(Rc, tc, w)
        Rc = torch.where(use2[:, None, None], R2, Rc)
        tc = torch.where(use2[:, None], t2, tc)
    Rf, tf = keep_better(R0, t0, Rc, tc, w)

    for _ in range(max(irls_rounds - 1, 0)):
        w = inlier_w(Rf, tf)
        Rc, tc = refine_pose_gn(Rf, tf, p3d, p2d, K, w, **gn)
        Rf, tf = keep_better(Rf, tf, Rc, tc, w)

    inliers = (reproj_errors(Rf, tf, p3d, p2d, K) < reproj_thresh).float() * valid
    finite = torch.isfinite(Rf).all(-1).all(-1) & torch.isfinite(tf).all(-1)
    success = (n_valid >= 4) & finite
    return {"R": torch.where(success[:, None, None], Rf, eye),
            "t": torch.where(success[:, None], tf, 0.0),
            "inliers": inliers, "num_inliers": inliers.sum(-1), "success": success}


def solve_poses_batched(p3d, p2d, valid, K, generator: Optional[torch.Generator] = None,
                        *, hyp_idx=None, device="cuda", **kw):
    """ransac_pnp over a batch of images on `device`.

    p3d: (N, 3) shared keypoints or (B, N, 3); p2d: (B, N, 2); valid: (B, N);
    K: (3, 3) or (B, 3, 3); numpy arrays or tensors. `generator` must live on
    `device` unless hyp_idx (B, H, S) is given. Returns a dict of tensors on
    `device`."""
    dev = resolve_device(device)
    p2d = torch.as_tensor(p2d, dtype=torch.float32, device=dev)
    B = p2d.shape[0]
    p3d = torch.as_tensor(p3d, dtype=torch.float32, device=dev)
    if p3d.dim() == 2:
        p3d = p3d.expand(B, *p3d.shape)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    if K.dim() == 2:
        K = K.expand(B, 3, 3)
    valid = torch.as_tensor(valid, dtype=torch.float32, device=dev)
    if hyp_idx is not None:
        hyp_idx = torch.as_tensor(hyp_idx, device=dev)
    with torch.inference_mode():
        return ransac_pnp(p3d, p2d, valid, K, generator, hyp_idx=hyp_idx, **kw)
