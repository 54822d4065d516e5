"""Losses (counterpart of checkerpose_tpu/losses/__init__.py).

Bit layout is (B, N, num_bits) (bits last); masks are (B, N, 1) and
broadcast over bits. Everything is computed in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _raw_bit_loss(logits, gt, loss_type: str):
    if loss_type == "BCE":
        return F.binary_cross_entropy_with_logits(logits, gt, reduction="none")
    if loss_type == "L1":
        return (torch.sigmoid(logits) - gt).abs()
    raise ValueError(f"loss_type {loss_type} not supported")


def unmasked_code_loss(logits, gt, loss_type: str = "BCE"):
    """Mean BCE-with-logits (or L1 on sigmoid) over all bits."""
    return _raw_bit_loss(logits.float(), gt.float(), loss_type).mean()


def masked_code_loss(logits, gt, gt_mask, loss_type: str = "BCE"):
    """Per-element code loss masked by the in-RoI bit.

    logits / gt: (B, N, num_bits); gt_mask: (B, N, 1); the normalizer is
    clamp(sum(mask), 1) * num_bits. loss_type "CE" is multi-class over the
    last axis with integer gt (B, N), normalized by clamp(sum(mask), 1).
    """
    logits = logits.float()
    if loss_type == "CE":
        raw = F.cross_entropy(logits.flatten(0, -2), gt.flatten().long(),
                              reduction="none").view(*gt.shape, 1)
        num_bits = 1
    else:
        raw = _raw_bit_loss(logits, gt.float(), loss_type)
        num_bits = logits.shape[-1]
    denom = gt_mask.sum().clamp_min(1.0) * num_bits
    return (raw * gt_mask).sum() / denom


def per_bit_masked_code_loss(logits, gt, gt_mask, bit_masks=None, bit_weights=None,
                             loss_type: str = "BCE"):
    """Masked code loss with per-bit normalization, masks and weights.

    logits / gt: (B, N, L); gt_mask: (B, N, 1); bit_masks: optional (B, N, L)
    extra multiplicative mask; bit_weights: optional length-L per-bit loss
    weights. Each bit's loss is normalized by its own supervised count
    (clamped to 1) and the per-bit losses are averaged, with `bit_weights`
    unnormalized (weights > 1 amplify that bit without shrinking the
    others). With neither it equals `masked_code_loss`.
    """
    if loss_type not in ("BCE", "L1"):
        raise ValueError(f"loss_type {loss_type} not supported for per-bit loss")
    raw = _raw_bit_loss(logits.float(), gt.float(), loss_type)
    m = gt_mask.expand_as(raw)
    if bit_masks is not None:
        m = m * bit_masks
    per_bit = (raw * m).sum((0, 1)) / m.sum((0, 1)).clamp_min(1.0)        # (L,)
    if bit_weights is not None:
        w = torch.as_tensor(bit_weights, dtype=torch.float32, device=raw.device)
        return (per_bit * w).sum() / raw.shape[-1]
    return per_bit.mean()


def mask_loss_interpolate(seg_logit, gt_mask):
    """L1 between sigmoid(pred mask) and the nearest-resized GT mask.

    seg_logit: (B, h, w), one channel of the seg head; gt_mask: (B, H, W)
    float {0., 1.}. The resize reads source index floor(i * H / h), computed
    in f32 (the legacy "nearest" rule, not the cell-centre one)."""
    h, w = seg_logit.shape[1:]
    H, W = gt_mask.shape[1:]
    dev = seg_logit.device
    yi = (torch.arange(h, dtype=torch.float32, device=dev) * (H / h)).long()
    xi = (torch.arange(w, dtype=torch.float32, device=dev) * (W / w)).long()
    resized = gt_mask[:, yi][:, :, xi]
    return (torch.sigmoid(seg_logit.float()) - resized).abs().mean()
