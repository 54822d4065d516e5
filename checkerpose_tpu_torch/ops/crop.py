"""Crop + resize on the host and on the device, and image normalization
(counterpart of checkerpose_tpu/ops/crop.py: `crop_square_resize_np`,
`crop_resize_np`, `get_roi_np`, `crop_bilinear`, `crop_nearest`,
`normalize_image`).

The host crop keeps the reference data pipeline's geometry
(`checkerpose/bop_dataset_pytorch.py:39-144`), int truncation of the corners
included, and resizes in numpy with `cv2.resize`'s geometry, so the port
needs no image library:
  * linear: half-pixel centres, edge pixels repeated, and for uint8 the
    fixed-point arithmetic of OpenCV's vectorised path (11-bit weights, the
    horizontal pass in int32, the vertical one as two 16-bit high products);
  * nearest: source index floor(i * src / dst).
"""
from __future__ import annotations

import numpy as np
import torch

from checkerpose_tpu_torch.ops.geometry import square_bbox

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_COEF_BITS = 11                      # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_ONE = 1 << _COEF_BITS


def _batched(crop):
    """Run a (B, H, W, ...) / (B, 4) crop on one image and bbox too."""
    def wrapped(img, bbox, crop_size: int):
        bbox = torch.as_tensor(bbox, dtype=torch.float32, device=img.device)
        if bbox.dim() == 1:
            return crop(img[None], bbox[None], crop_size)[0]
        return crop(img, bbox, crop_size)
    wrapped.__doc__ = crop.__doc__
    return wrapped


def _valid(yi, xi, H: int, W: int):
    """(B, S, S) bool: the taps at rows yi (B, S) and columns xi (B, S) that
    lie inside the image."""
    return ((yi >= 0) & (yi < H))[:, :, None] & ((xi >= 0) & (xi < W))[:, None, :]


def _taps(img, yi, xi):
    """img (B, H, W, ...) read at rows yi (B, S) x columns xi (B, S), both
    clamped into the image -> (B, S, S, ...)."""
    H, W = img.shape[1:3]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[b, yi.clamp(0, H - 1)[:, :, None], xi.clamp(0, W - 1)[:, None, :]]


@_batched
def crop_bilinear(img: torch.Tensor, bbox: torch.Tensor, crop_size: int) -> torch.Tensor:
    """Bilinear crop + resize on the device: an HWC image (or a (B, H, W, C)
    batch) and its final, already squared bbox [x, y, w, h] ((4,) or (B, 4))
    -> (crop_size, crop_size, C) (or (B, ...)), in the image's floating
    dtype (f32 for an integer image).

    cv2.resize(INTER_LINEAR)'s geometry on the zero-padded square crop:
    output pixel i samples (i + 0.5) * w / S - 0.5 + x; a tap outside the
    image reads 0 (the reference zero-pads)."""
    H, W = img.shape[1:3]
    S = crop_size
    i = torch.arange(S, dtype=torch.float32, device=img.device)
    sx = (i + 0.5) * (bbox[:, 2:3] / S) - 0.5 + bbox[:, 0:1]            # (B, S)
    sy = (i + 0.5) * (bbox[:, 3:4] / S) - 0.5 + bbox[:, 1:2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx = (sx - x0)[:, None, :, None]                                    # (B, 1, S, 1)
    wy = (sy - y0)[:, :, None, None]                                    # (B, S, 1, 1)
    x0, y0 = x0.long(), y0.long()
    dtype = img.dtype if img.is_floating_point() else torch.float32

    def tap(yi, xi):
        return _taps(img, yi, xi).to(dtype) * _valid(yi, xi, H, W)[..., None].to(dtype)

    return (tap(y0, x0) * (1 - wy) * (1 - wx)
            + tap(y0, x0 + 1) * (1 - wy) * wx
            + tap(y0 + 1, x0) * wy * (1 - wx)
            + tap(y0 + 1, x0 + 1) * wy * wx)


@_batched
def crop_nearest(img: torch.Tensor, bbox: torch.Tensor, crop_size: int) -> torch.Tensor:
    """Nearest-neighbour crop + resize on the device of an HW mask (or a
    (B, H, W) batch) by its final bbox -> (crop_size, crop_size) in the
    mask's dtype: output pixel i reads floor(i * w / S + x), as
    cv2.INTER_NEAREST does; outside the image it reads 0."""
    H, W = img.shape[1:3]
    S = crop_size
    i = torch.arange(S, dtype=torch.float32, device=img.device)
    sx = torch.floor(i * (bbox[:, 2:3] / S) + bbox[:, 0:1]).long()
    sy = torch.floor(i * (bbox[:, 3:4] / S) + bbox[:, 1:2]).long()
    return _taps(img, sy, sx) * _valid(sy, sx, H, W).to(img.dtype)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """uint8/float HWC (or NHWC) RGB in [0,255] -> ImageNet-normalized float32,
    channel-last like the input."""
    x = img.to(torch.float32) / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def _linear_taps(src: int, dst: int):
    """Per output index: the two source indices and their weights, as
    OpenCV computes them (f32 offsets, clamped at both edges)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    low, high = i0 < 0, i0 >= src - 1
    f[low | high] = 0.0
    i0 = np.where(low, 0, np.where(high, src - 1, i0))
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, f


def _resize_linear_u8(img: np.ndarray, size, rows=None, cols=None) -> np.ndarray:
    """To (size, size) or, for a pair, to (height, width); `rows` / `cols`
    (start, stop) compute only that part of the output, the same values."""
    h, w = img.shape[:2]
    oh, ow = (size, size) if isinstance(size, int) else size
    x0, x1, fx = (a[slice(*cols or (0, ow))] for a in _linear_taps(w, ow))
    y0, y1, fy = (a[slice(*rows or (0, oh))] for a in _linear_taps(h, oh))
    oh, ow = len(y0), len(x0)
    # weights rounded each on its own, as OpenCV's saturate_cast<short> does
    ax0 = np.rint((1.0 - fx) * _COEF_ONE).astype(np.int32)
    ax1 = np.rint(fx * _COEF_ONE).astype(np.int32)
    by0 = np.rint((1.0 - fy) * _COEF_ONE).astype(np.int32)
    by1 = np.rint(fy * _COEF_ONE).astype(np.int32)
    shape = (1, ow) + (1,) * (img.ndim - 2)
    rows = img.astype(np.int32)
    hx = rows[:, x0] * ax0.reshape(shape) + rows[:, x1] * ax1.reshape(shape)   # (h, ow, ...)
    shape = (oh,) + (1,) * (img.ndim - 1)
    d0, d1 = hx[y0] >> 4, hx[y1] >> 4
    out = ((by0.reshape(shape) * d0) >> 16) + ((by1.reshape(shape) * d1) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def resize_linear_u8(img: np.ndarray, height: int, width: int, rows=None,
                     cols=None) -> np.ndarray:
    """Bilinear resize of an (h, w[, c]) uint8 image to (height, width[, c])
    with `cv2.resize(..., INTER_LINEAR)`'s geometry and fixed point; with
    `rows` and `cols` ((start, stop) each), only that window of the result."""
    return _resize_linear_u8(np.asarray(img, np.uint8), (height, width), rows, cols)


def _resize_linear_float(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    x0, x1, fx = _linear_taps(w, size)
    y0, y1, fy = _linear_taps(h, size)
    shape = (1, size) + (1,) * (img.ndim - 2)
    x = img.astype(np.float32)
    hx = x[:, x0] * (1.0 - fx).reshape(shape) + x[:, x1] * fx.reshape(shape)
    shape = (size,) + (1,) * (img.ndim - 1)
    out = hx[y0] * (1.0 - fy).reshape(shape) + hx[y1] * fy.reshape(shape)
    return out.astype(img.dtype)


def _resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(size) * (1.0 / (size / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(size) * (1.0 / (size / h))).astype(np.int64), h - 1)
    return img[ys][:, xs]


def _resize_np(img: np.ndarray, crop_size: int, interpolation: str) -> np.ndarray:
    """Resize an (h, w[, c]) image to (crop_size, crop_size[, c])."""
    if img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError(f"cannot resize an empty image of shape {img.shape}")
    if interpolation != "linear":
        return _resize_nearest(img, crop_size)
    if img.dtype == np.uint8:
        return _resize_linear_u8(img, crop_size)
    return _resize_linear_float(img, crop_size)


def _square(bbox):
    """(x1, y1, x2, y2, side) of the square crop around bbox."""
    x1, y1, bw, bh = int(bbox[0]), int(bbox[1]), int(bbox[2]), int(bbox[3])
    sq = square_bbox(np.array([x1, y1, bw, bh]))
    x1, y1 = int(sq[0]), int(sq[1])
    return x1, y1, x1 + int(sq[2]), y1 + int(sq[3]), int(max(bh, bw))


def roi_window(bbox, resize_method: str, height: int, width: int):
    """(y0, y1, x0, x1): the part of a height x width frame `get_roi_np`
    reads for bbox; nothing outside it reaches the crop."""
    if resize_method == "crop_resize":
        return (max(0, int(bbox[1])), min(height, int(bbox[1] + bbox[3])),
                max(0, int(bbox[0])), min(width, int(bbox[0] + bbox[2])))
    x1, y1, x2, y2, _ = _square(bbox)
    return max(y1, 0), min(y2, height), max(x1, 0), min(x2, width)


def crop_square_resize_np(img: np.ndarray, bbox, crop_size: int,
                          interpolation: str = "linear") -> np.ndarray:
    """Zero-pad the bbox to square, crop (clipping to the image), resize."""
    x1, y1, x2, y2, side = _square(bbox)
    roi = np.zeros((side, side) + img.shape[2:], dtype=img.dtype)
    rx1 = max(-x1, 0)
    x1c = max(x1, 0)
    rx2 = rx1 + min(img.shape[1] - x1c, x2 - x1c)
    ry1 = max(-y1, 0)
    y1c = max(y1, 0)
    ry2 = ry1 + min(img.shape[0] - y1c, y2 - y1c)
    y0w, y1w, x0w, x1w = roi_window(bbox, "crop_square_resize", *img.shape[:2])
    roi[ry1:ry2, rx1:rx2] = img[y0w:y1w, x0w:x1w]
    return _resize_np(roi, crop_size, interpolation)


def crop_resize_np(img: np.ndarray, bbox, crop_size: int,
                   interpolation: str = "linear") -> np.ndarray:
    """Clip bbox to image, crop, resize (aspect NOT preserved)."""
    y1, y2, x1, x2 = roi_window(bbox, "crop_resize", *img.shape[:2])
    return _resize_np(img[y1:y2, x1:x2], crop_size, interpolation)


def get_roi_np(img: np.ndarray, bbox, crop_size: int, interpolation: str,
               resize_method: str) -> np.ndarray:
    """The reference's `get_roi` dispatch; `crop_resize_by_warp_affine` is the
    square crop (geometrically equal for rotation 0, the only one used)."""
    if resize_method == "crop_resize":
        return crop_resize_np(img, bbox, crop_size, interpolation)
    if resize_method in ("crop_square_resize", "crop_resize_by_warp_affine"):
        return crop_square_resize_np(img, bbox, crop_size, interpolation)
    raise NotImplementedError(f"unknown resize_method: {resize_method}")
