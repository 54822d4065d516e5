"""Color augmentations, batched on the device (counterpart of
checkerpose_tpu/ops/augment.py).

The same op set, order and probabilities as the JAX package's
`color_augment`. Every op is split in two: `draw_<op>(generator, ...)` draws
its parameters for a whole batch from a `torch.Generator` (on the device the
images live on), and `<op>(img, params...)` applies given parameters. The
random streams of JAX and torch differ, so only the second half can be held
against the JAX package; `draw_color_augment` + `apply_color_augment` are the
whole chain.

All ops take and return float32 (B, H, W, 3) images in [0, 255].
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def _rand(gen: torch.Generator, *shape, lo: float = 0.0, hi: float = 1.0):
    return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=gen.device)


def _select(hit, a, b):
    """Per-sample choice: a where hit (B,) else b, for (B, ...) tensors."""
    return torch.where(hit.view(-1, *([1] * (a.dim() - 1))), a, b)


# --- salt and pepper -------------------------------------------------------

def draw_salt_and_pepper(gen, B: int, H: int, W: int, p: float = 0.05):
    """(hit, salt): (B, H, W) bool, pixel replaced with prob p; by 255 with
    prob 0.5, else by 0."""
    return _rand(gen, B, H, W) < p, _rand(gen, B, H, W) < 0.5


def salt_and_pepper(img, hit, salt):
    repl = torch.where(salt, 255.0, 0.0)[..., None]
    return torch.where(hit[..., None], repl, img)


# --- blurs: depthwise k x k, zero "SAME" padding ---------------------------

def motion_kernels(k: int = 5, device=None) -> torch.Tensor:
    """Four k-tap line kernels (horizontal, vertical, two diagonals), (4, k, k)."""
    h = torch.zeros(k, k)
    h[k // 2, :] = 1.0 / k
    d1 = torch.eye(k) / k
    return torch.stack([h, h.t(), d1, d1.flip(1)]).to(device)


def depthwise_conv(img, kern):
    """img (B, H, W, 3), kern (B, k, k): each sample's own kernel on each of
    its channels (cross-correlation, zero padding, same size)."""
    B, H, W, C = img.shape
    k = kern.shape[-1]
    x = img.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    w = kern[:, None].expand(B, C, k, k).reshape(B * C, 1, k, k)
    y = F.conv2d(x, w, padding=k // 2, groups=B * C)
    return y.view(B, C, H, W).permute(0, 2, 3, 1)


def draw_motion_blur(gen, B: int):
    """idx (B,) int64 into `motion_kernels`."""
    return torch.randint(0, 4, (B,), generator=gen, device=gen.device)


def motion_blur(img, idx, k: int = 5):
    return depthwise_conv(img, motion_kernels(k, img.device)[idx])


def draw_gaussian_blur(gen, B: int, max_sigma: float = 1.0):
    """sigma (B,) uniform in [0, max_sigma)."""
    return _rand(gen, B, hi=max_sigma)


def gaussian_blur(img, sigma, k: int = 5):
    sigma = sigma.clamp_min(1e-3)[:, None]
    r = torch.arange(k, dtype=torch.float32, device=img.device) - (k - 1) / 2
    g = torch.exp(-0.5 * (r / sigma) ** 2)
    g = g / g.sum(-1, keepdim=True)                                  # (B, k)
    return depthwise_conv(img, g[:, :, None] * g[:, None, :])


# --- coarse dropout ---------------------------------------------------------

def coarse_dropout_grid(H: int, W: int, size_percent: float = 0.05):
    return max(int(H * size_percent), 1), max(int(W * size_percent), 1)


def draw_coarse_dropout(gen, B: int, H: int, W: int, p: float = 0.1,
                        size_percent: float = 0.05):
    """keep (B, h, w) bool on the coarse grid; a cell is dropped with prob p."""
    return _rand(gen, B, *coarse_dropout_grid(H, W, size_percent)) >= p


def coarse_dropout(img, keep):
    """The coarse keep-mask is resized to the image by sampling cell
    centres, source index floor((i + 0.5) * h / H): "nearest-exact"."""
    H, W = img.shape[1:3]
    full = F.interpolate(keep[:, None].float(), size=(H, W), mode="nearest-exact")
    return img * full[:, 0, :, :, None]


# --- per-channel arithmetic -------------------------------------------------

def draw_channel_values(gen, B: int, lo: float, hi: float, per_channel_p: float):
    """(B, 3) uniform in [lo, hi): with prob per_channel_p one value per
    channel, else one value shared by the three."""
    per_ch = _rand(gen, B) < per_channel_p
    v_ch = _rand(gen, B, 3, lo=lo, hi=hi)
    v_one = _rand(gen, B, 1, lo=lo, hi=hi).expand(B, 3)
    return _select(per_ch, v_ch, v_one)


def draw_add_value(gen, B: int, lo=-20.0, hi=20.0, per_channel_p=0.3):
    return draw_channel_values(gen, B, lo, hi, per_channel_p)


def add_value(img, v):
    return img + v[:, None, None, :]


def draw_invert(gen, B: int, p: float = 0.2):
    """hit (B, 3) bool: the channels to invert."""
    return _rand(gen, B, 3) < p


def invert(img, hit):
    return torch.where(hit[:, None, None, :], 255.0 - img, img)


def draw_multiply(gen, B: int, lo=0.7, hi=1.4, per_channel_p=0.0):
    return draw_channel_values(gen, B, lo, hi, per_channel_p)


def multiply(img, m):
    return img * m[:, None, None, :]


def draw_contrast_normalization(gen, B: int, lo=0.5, hi=2.0, per_channel_p=0.3):
    return draw_channel_values(gen, B, lo, hi, per_channel_p)


def contrast_normalization(img, a):
    return (img - 127.5) * a[:, None, None, :] + 127.5


# --- the chain ---------------------------------------------------------------

# (name, probability, draw(gen, B, H, W) -> parameters, apply) in the JAX
# package's order; "multiply_ch" is multiply with per_channel_p = 0.8
_CHAIN = (
    ("salt_and_pepper", 0.3, draw_salt_and_pepper, salt_and_pepper),
    ("motion_blur", 0.2, lambda g, B, H, W: (draw_motion_blur(g, B),), motion_blur),
    ("coarse_dropout", 0.4, lambda g, B, H, W: (draw_coarse_dropout(g, B, H, W),),
     coarse_dropout),
    ("gaussian_blur", 0.5, lambda g, B, H, W: (draw_gaussian_blur(g, B),), gaussian_blur),
    ("add_value", 0.5, lambda g, B, H, W: (draw_add_value(g, B),), add_value),
    ("invert", 0.4, lambda g, B, H, W: (draw_invert(g, B),), invert),
    ("multiply_ch", 0.5, lambda g, B, H, W: (draw_multiply(g, B, per_channel_p=0.8),), multiply),
    ("multiply", 0.5, lambda g, B, H, W: (draw_multiply(g, B),), multiply),
    ("contrast_normalization", 0.5,
     lambda g, B, H, W: (draw_contrast_normalization(g, B),), contrast_normalization),
)


def draw_color_augment(gen: torch.Generator, B: int, H: int, W: int,
                       use_pepper_salt: bool = True, use_motion_blur: bool = True,
                       apply_prob: float = 0.8) -> Dict[str, Optional[tuple]]:
    """The parameters of one pass of the chain over a batch: {"apply": (B,)
    bool outer gate, <op>: (gate (B,) bool, *op parameters) or None where the
    op is switched off}."""
    off = {"salt_and_pepper": not use_pepper_salt, "motion_blur": not use_motion_blur}
    params: Dict[str, Optional[tuple]] = {"apply": _rand(gen, B) < apply_prob}
    for name, p, draw, _ in _CHAIN:
        params[name] = None if off.get(name) else (_rand(gen, B) < p, *draw(gen, B, H, W))
    return params


def rows_of(params, rows: slice):
    """The parameters that `draw_color_augment` drew for the given rows of
    its batch (every parameter's leading axis is the batch)."""
    return {k: None if v is None else
            (v[rows] if isinstance(v, torch.Tensor) else tuple(t[rows] for t in v))
            for k, v in params.items()}


def apply_color_augment(img, params):
    """The chain with given parameters: each op where its gate is set, the
    clip to [0, 255], and the whole where the outer gate is set. Every
    sample computes both branches and selects, as the JAX package's vmapped
    `_maybe` does."""
    x = img
    for name, _, _, fn in _CHAIN:
        if params[name] is not None:
            gate, *args = params[name]
            x = _select(gate, fn(x, *args), x)
    return _select(params["apply"], x.clamp(0.0, 255.0), img)


def color_augment(gen: torch.Generator, img, use_pepper_salt: bool = True,
                  use_motion_blur: bool = True, apply_prob: float = 0.8):
    """Draw and apply the chain on a (B, H, W, 3) float batch in [0, 255]."""
    B, H, W, _ = img.shape
    return apply_color_augment(img, draw_color_augment(
        gen, B, H, W, use_pepper_salt, use_motion_blur, apply_prob))
