"""Batched depth rasterizer on the device for the NOCS labels
(counterpart of checkerpose_tpu/ops/raster.py).

A brute-force pixel-against-face test over chunks of 128 faces with
perspective-correct 1/z interpolation and a min z-buffer: the semantics of
eval/renderer.py::render_depth (the host z-buffer that VSD uses), on crop
grids and in plain PyTorch, as the JAX package computes it in plain jnp.
"""
from __future__ import annotations

import numpy as np
import torch

_CHUNK = 128            # faces a step
_MAX_ELEMS = 1 << 25    # elements of one (b, CHUNK, S, S) f32 intermediate: 128 MiB


def crop_intrinsics(cam_K: torch.Tensor, bbox: torch.Tensor, S: int):
    """(fx, fy, cx, cy) (B,) of the crop: a final square bbox [x, y, w, h]
    mapped to an S-grid, fx' = fx S / w, cx' = (cx - x) S / w. A dummy
    sample's zero bbox is clamped to 1e-3. cam_K (B, 3, 3), bbox (B, 4)."""
    bw = bbox[:, 2].clamp_min(1e-3)
    bh = bbox[:, 3].clamp_min(1e-3)
    fx = cam_K[:, 0, 0] * S / bw
    fy = cam_K[:, 1, 1] * S / bh
    cx = (cam_K[:, 0, 2] - bbox[:, 0]) * S / bw
    cy = (cam_K[:, 1, 2] - bbox[:, 1]) * S / bh
    return fx, fy, cx, cy


def face_chunks(faces, device=None) -> torch.Tensor:
    """(n_chunks, CHUNK, 3) int64 faces, padded with zero-area faces (which
    the test rejects)."""
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    pad = (-len(f)) % _CHUNK
    f = np.concatenate([f, np.zeros((pad, 3), np.int64)])
    return torch.as_tensor(f.reshape(-1, _CHUNK, 3), device=device)


@torch.no_grad()
def render_depth_crops(verts, faces, R, t, cam_K, bbox, S: int) -> torch.Tensor:
    """Depth (B, S, S) f32 (0 = background) of a posed mesh on crop grids.

    verts (V, 3), faces (F, 3) (arrays, or tensors; `face_chunks(faces)`
    may be passed instead of the faces); R (B, 3, 3), t (B, 3), cam_K
    (B, 3, 3) of the original image, bbox (B, 4) the final square crop
    [x, y, w, h], all on one device. Depth is in t's unit. Samples are
    taken in groups whose (b, 128, S, S) intermediates stay under 2^25
    elements."""
    dev = R.device
    verts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    chunks = (faces.to(dev) if isinstance(faces, torch.Tensor) and faces.dim() == 3
              else face_chunks(faces, dev))
    fx, fy, cx, cy = crop_intrinsics(cam_K.float(), bbox.float(), S)
    group = max(1, _MAX_ELEMS // (_CHUNK * S * S))
    out = [_render_group(verts, chunks, R[i:i + group].float(), t[i:i + group].float(),
                         fx[i:i + group], fy[i:i + group], cx[i:i + group],
                         cy[i:i + group], S)
           for i in range(0, R.shape[0], group)]
    return torch.cat(out) if out else torch.zeros(0, S, S, device=dev)


def _render_group(verts, chunks, R, t, fx, fy, cx, cy, S):
    cam = torch.einsum("vj,bij->bvi", verts, R) + t[:, None, :]          # (b, V, 3)
    z = cam[..., 2]
    zok = z > 1e-6
    zs = z.clamp_min(1e-6)
    u = fx[:, None] * cam[..., 0] / zs + cx[:, None]                     # (b, V)
    v = fy[:, None] * cam[..., 1] / zs + cy[:, None]
    w = 1.0 / zs
    g = torch.arange(S, dtype=torch.float32, device=R.device) + 0.5      # pixel centres
    gx = g.view(1, 1, 1, S)                                               # x along the last axis
    gy = g.view(1, 1, S, 1)
    zbuf = torch.full((R.shape[0], S, S), float("inf"), device=R.device)
    for tri in chunks:                                                    # (CHUNK, 3)
        pu, pv, ww = u[:, tri], v[:, tri], w[:, tri]                     # (b, C, 3)
        ok = zok[:, tri].all(-1)                                          # near-plane cull
        area = ((pu[..., 1] - pu[..., 0]) * (pv[..., 2] - pv[..., 0])
                - (pv[..., 1] - pv[..., 0]) * (pu[..., 2] - pu[..., 0]))
        ok &= area.abs() > 1e-12

        def edge(a, b):      # signed area of (a, b, pixel), (b, C, S, S)
            return ((pu[..., b] - pu[..., a])[..., None, None] * (gy - pv[..., a][..., None, None])
                    - (pv[..., b] - pv[..., a])[..., None, None]
                    * (gx - pu[..., a][..., None, None]))

        e0, e1, e2 = edge(1, 2), edge(2, 0), edge(0, 1)
        sgn = torch.sign(area)[..., None, None]
        inside = (e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0)
        inv_area = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)),
                               torch.zeros_like(area))
        invz = (e0 * ww[..., 0, None, None] + e1 * ww[..., 1, None, None]
                + e2 * ww[..., 2, None, None]) * inv_area[..., None, None]
        hit = inside & (invz > 1e-12) & ok[..., None, None]
        zpix = torch.where(hit, 1.0 / invz.clamp_min(1e-12), float("inf"))
        zbuf = torch.minimum(zbuf, zpix.amin(1))
    return torch.where(torch.isfinite(zbuf), zbuf, torch.zeros_like(zbuf))
