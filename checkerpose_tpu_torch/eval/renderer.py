"""Depth renderer on the host: a vectorized tiled z-buffer triangle
rasterizer in numpy (the port's copy of checkerpose_tpu/eval/renderer.py).

It stands in for the OpenGL `bop_renderer` the reference's BOP scoring uses
for VSD only (`bop_toolkit_lib/renderer_cpp.py:13-62`). Depth rendering is an
offline scoring step, never on the train or serve path, so it stays on the
host: no GL context, no card, deterministic.

Algorithm: triangles are bucketed by screen-space bbox size; each bucket is
rasterized as an (n, T, T) block of edge-function tests with perspective-
correct depth (1/z interpolated linearly in screen space), then z-buffered
with np.minimum.at on flat pixel indices.
"""
from __future__ import annotations

import numpy as np

_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)
_CHUNK_PX = 8_000_000  # max (n * T * T) per vectorized block


def render_depth(verts: np.ndarray, faces: np.ndarray, R: np.ndarray,
                 t: np.ndarray, K: np.ndarray, im_w: int = 640,
                 im_h: int = 480) -> np.ndarray:
    """Depth (z, same unit as t; 0 = background) of a posed mesh.

    verts (V,3), faces (F,3) int, R (3,3), t (3,), K (3,3).
    """
    cam = verts @ np.asarray(R).T + np.asarray(t).reshape(1, 3)
    z = cam[:, 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * cam[:, 0] / np.maximum(z, 1e-9) + cx
    v = fy * cam[:, 1] / np.maximum(z, 1e-9) + cy

    tri = np.asarray(faces, np.int64)
    # cull faces with any vertex behind the camera (BOP objects are always
    # fully in front; no near-plane clipping needed)
    ok = (z[tri] > 1e-6).all(axis=1)
    tri = tri[ok]
    if len(tri) == 0:
        return np.zeros((im_h, im_w), np.float32)

    px = np.stack([u, v], axis=1)
    p0, p1, p2 = px[tri[:, 0]], px[tri[:, 1]], px[tri[:, 2]]
    w0, w1, w2 = 1.0 / z[tri[:, 0]], 1.0 / z[tri[:, 1]], 1.0 / z[tri[:, 2]]

    def lo_hi(c, size):
        a, b, d = p0[:, c], p1[:, c], p2[:, c]
        lo = np.clip(np.floor(np.minimum(np.minimum(a, b), d)), 0, size - 1)
        hi = np.clip(np.ceil(np.maximum(np.maximum(a, b), d)), 0, size - 1)
        return lo.astype(np.int64), hi.astype(np.int64)

    xmin, xmax = lo_hi(0, im_w)
    ymin, ymax = lo_hi(1, im_h)
    size = np.maximum(xmax - xmin, ymax - ymin) + 1

    area = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
            - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0]))
    nondeg = np.abs(area) > 1e-12

    zflat = np.full(im_h * im_w, np.inf, np.float32)
    lo = 0
    # the clipped extent never exceeds the image, so one bucket at
    # max(im_w, im_h) after the static ones takes every triangle, on frames
    # wider than the largest static bucket too (1280 px ITODD)
    big = max(im_w, im_h)
    buckets = [b for b in _BUCKETS if b < big] + [big]
    for T in buckets:
        sel = np.nonzero(nondeg & (size > lo) & (size <= T))[0]
        lo = T
        if len(sel) == 0:
            continue
        step = max(_CHUNK_PX // (T * T), 1)
        for s in range(0, len(sel), step):
            idx = sel[s:s + step]
            _raster_block(zflat, p0[idx], p1[idx], p2[idx], w0[idx], w1[idx],
                          w2[idx], area[idx], xmin[idx], ymin[idx], T,
                          im_w, im_h)
    out = zflat.reshape(im_h, im_w)
    out[~np.isfinite(out)] = 0.0
    return out


def _raster_block(zflat, p0, p1, p2, w0, w1, w2, area, xmin, ymin, T,
                  im_w, im_h):
    gx = xmin[:, None, None] + np.arange(T)[None, None, :] + 0.5  # pixel centers
    gy = ymin[:, None, None] + np.arange(T)[None, :, None] + 0.5

    def edge(a, b):
        return ((b[:, 0] - a[:, 0])[:, None, None] * (gy - a[:, 1][:, None, None])
                - (b[:, 1] - a[:, 1])[:, None, None] * (gx - a[:, 0][:, None, None]))

    e0 = edge(p1, p2)   # opposite vertex 0
    e1 = edge(p2, p0)
    e2 = edge(p0, p1)
    sgn = np.sign(area)[:, None, None]
    inside = (e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0)
    inside &= (gx < im_w) & (gy < im_h)

    inv_area = (1.0 / area)[:, None, None]
    invz = (e0 * inv_area * w0[:, None, None] + e1 * inv_area * w1[:, None, None]
            + e2 * inv_area * w2[:, None, None])
    inside &= invz > 1e-12
    zpix = 1.0 / np.maximum(invz, 1e-12)

    flat = (gy.astype(np.int64) * im_w + gx.astype(np.int64))
    np.minimum.at(zflat, flat[inside], zpix[inside].astype(np.float32))
