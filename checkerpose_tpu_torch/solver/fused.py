"""The RANSAC-EPnP kernel of `csrc/ransac.cu`, bound by ctypes: the route
"fused" of `solver/ransac.py::ransac_pnp` for CUDA tensors.

Two launches a call, on the current stream, with no synchronisation and no
allocation beyond the outputs made here:

  `hypotheses`  each row's hypotheses (hyp_idx, sampled by the caller) solved
                by EPnP, scored over the row's points, the best kept;
  `refine`      ransac_pnp's IRLS rounds of Gauss-Newton from that best, the
                reseed EPnP, the inlier mask, the success flag.

`MAX_N` and `MAX_SAMPLE` mirror the source's limits (a card test holds them
against its C functions); `ransac.py::solver_route` sends a call beyond them
to the eager chain.

`launches_by_route` counts the solver's two stages (hypotheses, refine) by
the route that ran them: "fused" here, one kernel launch a stage, next to
each launch; "eager" in ransac.py, one chain of PyTorch operations a stage.
It is `ransac_pnp.launches_by_route`, and `reset_launch_counts()` of
`utils/counters.py` zeroes it in place.
"""
from __future__ import annotations

import ctypes

import torch

from checkerpose_tpu_torch.ops import _build
from checkerpose_tpu_torch.utils import counters

MAX_N = 4096          # points of a row: a row lives in one block's shared memory
MAX_SAMPLE = 16       # points of a hypothesis: one thread's EPnP

launches_by_route = {"fused": 0, "eager": 0}


@counters.register
def _reset_counts():
    launches_by_route.update(fused=0, eager=0)


def _lib() -> ctypes.CDLL:
    """The library, built at first use, its functions typed once."""
    return typed(_build.load("ransac"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C functions' argument and result types, once per library
    (a host build of the source for the CPU tests exports the same ones)."""
    if not getattr(lib, "_typed", False):
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.ransac_hypotheses_launch.argtypes = [p, ll, p, p, p, ll, p, i, i, i, i, f, f, p, p,
                                                 p]
        lib.ransac_hypotheses_launch.restype = i
        lib.ransac_refine_launch.argtypes = [p, ll, p, p, p, ll, p, i, i, f, f, f, f, i, i, i,
                                             i, p, p, p, p, p, p]
        lib.ransac_refine_launch.restype = i
        for name in ("ransac_max_n", "ransac_max_sample"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        for name in ("ransac_hypotheses_smem_bytes", "ransac_refine_smem_bytes"):
            getattr(lib, name).argtypes = [i, i]
            getattr(lib, name).restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _stream(t: torch.Tensor) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"the fused solver runs on CUDA tensors, got {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows(x: torch.Tensor, inner: int):
    """(x, rows' stride in floats) for a (B, r, inner) f32 batch whose rows
    are each contiguous: a stride-0 batch (an `expand`) is kept as it is."""
    x = x.float()
    if x.stride(-1) != 1 or x.stride(-2) != inner:
        x = x.contiguous()
    return x, x.stride(0)


def _inputs(p3d, p2d, valid, K):
    B, N = p2d.shape[:2]
    if tuple(p3d.shape) != (B, N, 3) or tuple(valid.shape) != (B, N) \
            or tuple(K.shape) != (B, 3, 3) or p2d.shape[-1] != 2:
        raise ValueError(f"expected p3d (B, N, 3), p2d (B, N, 2), valid (B, N), K (B, 3, 3); "
                         f"got {tuple(p3d.shape)}, {tuple(p2d.shape)}, {tuple(valid.shape)}, "
                         f"{tuple(K.shape)}")
    if N > MAX_N:
        raise ValueError(f"N={N} points exceed the kernel's {MAX_N}")
    if any(t.device != p2d.device for t in (p3d, valid, K)):
        raise ValueError("all tensors must be on one device")
    p3d, p3d_bs = _rows(p3d, 3)
    K, K_bs = _rows(K, 3)
    return p3d, p3d_bs, p2d.float().contiguous(), valid.float().contiguous(), K, K_bs


def hypotheses(p3d, p2d, valid, K, hyp_idx, reproj_thresh: float,
               soft_inlier_sigma: float):
    """The best hypothesis of each row: (pose (B, 12) f32, R row-major then
    t; its index (B,) int32). hyp_idx (B, H, S) with entries in [0, N)."""
    p3d, p3d_bs, p2d, valid, K, K_bs = _inputs(p3d, p2d, valid, K)
    B, N = p2d.shape[:2]
    if hyp_idx.dim() != 3 or hyp_idx.shape[0] != B or not 1 <= hyp_idx.shape[2] <= MAX_SAMPLE \
            or hyp_idx.shape[1] < 1:
        raise ValueError(f"hyp_idx must be (B={B}, H >= 1, 1 <= S <= {MAX_SAMPLE}), "
                         f"got {tuple(hyp_idx.shape)}")
    H, S = hyp_idx.shape[1:]
    hyp = hyp_idx.to(device=p2d.device, dtype=torch.int64).contiguous()
    pose = torch.empty((B, 12), dtype=torch.float32, device=p2d.device)
    best = torch.empty((B,), dtype=torch.int32, device=p2d.device)
    if B == 0:
        return pose, best
    stream = _stream(p2d)
    err = _lib().ransac_hypotheses_launch(
        p3d.data_ptr(), p3d_bs, p2d.data_ptr(), valid.data_ptr(), K.data_ptr(), K_bs,
        hyp.data_ptr(), B, N, H, S, float(reproj_thresh), float(soft_inlier_sigma),
        pose.data_ptr(), best.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ransac_hypotheses launch failed: CUDA error {err}")
    launches_by_route["fused"] += 1
    return pose, best


def refine(p3d, p2d, valid, K, pose0, *, reproj_thresh: float, refine_iters: int,
           irls_rounds: int, soft_inlier_sigma: float, coherence_weight: float,
           neighborhood_radius: float, reseed: bool, n_backtrack: int):
    """ransac_pnp's answer from the best hypotheses pose0 (B, 12): dict(R
    (B, 3, 3), t (B, 3), inliers (B, N), num_inliers (B,), success (B,)
    bool)."""
    p3d, p3d_bs, p2d, valid, K, K_bs = _inputs(p3d, p2d, valid, K)
    B, N = p2d.shape[:2]
    if refine_iters < 0 or n_backtrack < 0:
        raise ValueError(f"refine_iters and n_backtrack must be >= 0, got {refine_iters}, "
                         f"{n_backtrack}")
    dev = p2d.device
    out = {"R": torch.empty((B, 3, 3), dtype=torch.float32, device=dev),
           "t": torch.empty((B, 3), dtype=torch.float32, device=dev),
           "inliers": torch.empty((B, N), dtype=torch.float32, device=dev),
           "num_inliers": torch.empty((B,), dtype=torch.float32, device=dev),
           "success": torch.empty((B,), dtype=torch.bool, device=dev)}
    if B == 0:
        return out
    stream = _stream(p2d)
    pose0 = pose0.float().contiguous()
    err = _lib().ransac_refine_launch(
        p3d.data_ptr(), p3d_bs, p2d.data_ptr(), valid.data_ptr(), K.data_ptr(), K_bs,
        pose0.data_ptr(), B, N, float(reproj_thresh), float(soft_inlier_sigma),
        float(coherence_weight), float(neighborhood_radius) ** 2, int(refine_iters),
        int(n_backtrack), int(irls_rounds), int(bool(reseed)), out["R"].data_ptr(),
        out["t"].data_ptr(), out["inliers"].data_ptr(), out["num_inliers"].data_ptr(),
        out["success"].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ransac_refine launch failed: CUDA error {err}")
    launches_by_route["fused"] += 1
    return out
