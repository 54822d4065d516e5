"""Binary-code codec: pixel index <-> MSB-first binary code (counterpart of
checkerpose_tpu/ops/codes.py).

Codes are MSB-first, id = sum_i code[i] * 2**(L-1-i), base 2, on any leading
batch dims and on the input's device.
"""
from __future__ import annotations

import torch


def _shifts(num_bits: int, device) -> torch.Tensor:
    return num_bits - 1 - torch.arange(num_bits, dtype=torch.int32, device=device)


def ids_to_codes(ids: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Integer ids (...,) -> MSB-first binary codes (..., num_bits), int32."""
    ids = ids.to(torch.int32)
    return (ids[..., None] >> _shifts(num_bits, ids.device)) & 1


def codes_to_ids(codes: torch.Tensor) -> torch.Tensor:
    """MSB-first binary codes (..., num_bits), float {0., 1.} or int ->
    integer ids (...,), int32."""
    weights = 1 << _shifts(codes.shape[-1], codes.device)
    return (codes.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def probs_to_bits(logits: torch.Tensor) -> torch.Tensor:
    """Network logits -> hard {0,1} int32 bits; sigmoid(x) > 0.5 <=> x > 0."""
    return (logits > 0.0).to(torch.int32)


def logits_to_ids(logits: torch.Tensor) -> torch.Tensor:
    """Logits (..., num_bits) -> integer ids via hard thresholding."""
    return codes_to_ids(probs_to_bits(logits))


def logits_to_mask(logits: torch.Tensor) -> torch.Tensor:
    """Logits -> float32 {0., 1.} mask."""
    return (logits > 0.0).to(torch.float32)
