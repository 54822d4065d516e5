"""Port losses vs checkerpose_tpu/losses, f32 on the CPU, same numpy inputs:
1e-5 relative (sums of a few hundred O(1) terms in f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu import losses as jlosses
from checkerpose_tpu_torch import losses

B, N, L = 3, 20, 6
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed=0, empty_mask=False):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((B, N, L))).astype(np.float32)
    gt = (rng.random((B, N, L)) > 0.5).astype(np.float32)
    mask = np.zeros((B, N, 1), np.float32) if empty_mask else \
        (rng.random((B, N, 1)) > 0.3).astype(np.float32)
    return logits, gt, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("loss_type", ["BCE", "L1"])
def test_unmasked_code_loss(loss_type):
    logits, gt, _ = _inputs(1)
    ref = float(jlosses.unmasked_code_loss(jnp.asarray(logits), jnp.asarray(gt), loss_type))
    got = float(losses.unmasked_code_loss(*_t(logits, gt), loss_type))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("empty_mask", [False, True], ids=["mask", "empty_mask"])
@pytest.mark.parametrize("loss_type", ["BCE", "L1", "CE"])
def test_masked_code_loss(loss_type, empty_mask):
    logits, gt, mask = _inputs(2, empty_mask)
    if loss_type == "CE":
        gt = np.random.default_rng(3).integers(0, L, (B, N)).astype(np.int32)
    ref = float(jlosses.masked_code_loss(jnp.asarray(logits), jnp.asarray(gt),
                                         jnp.asarray(mask), loss_type))
    got = float(losses.masked_code_loss(*_t(logits, gt, mask), loss_type))
    np.testing.assert_allclose(got, ref, **TOL)
    if empty_mask:
        assert got == 0.0                        # clamp(sum(mask), 1): 0, not NaN


@pytest.mark.parametrize("case", ["plain", "bit_masks", "bit_weights", "both", "empty_mask"])
@pytest.mark.parametrize("loss_type", ["BCE", "L1"])
def test_per_bit_masked_code_loss(loss_type, case):
    logits, gt, mask = _inputs(4, case == "empty_mask")
    rng = np.random.default_rng(5)
    bit_masks = (rng.random((B, N, L)) > 0.4).astype(np.float32) \
        if case in ("bit_masks", "both") else None
    bit_weights = (1.0, 1.0, 1.0, 1.0, 2.5, 2.5) if case in ("bit_weights", "both") else None
    ref = float(jlosses.per_bit_masked_code_loss(
        jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(mask),
        None if bit_masks is None else jnp.asarray(bit_masks), bit_weights, loss_type))
    got = float(losses.per_bit_masked_code_loss(
        *_t(logits, gt, mask), None if bit_masks is None else torch.from_numpy(bit_masks),
        bit_weights, loss_type))
    np.testing.assert_allclose(got, ref, **TOL)
    if case == "plain":                          # equals the shared-mask loss
        np.testing.assert_allclose(
            got, float(losses.masked_code_loss(*_t(logits, gt, mask), loss_type)), **TOL)


def test_loss_types_are_checked():
    logits, gt, mask = _t(*_inputs(6))
    with pytest.raises(ValueError):
        losses.unmasked_code_loss(logits, gt, "CE")
    with pytest.raises(ValueError):
        losses.masked_code_loss(logits, gt, mask, "L2")
    with pytest.raises(ValueError):
        losses.per_bit_masked_code_loss(logits, gt, mask, loss_type="CE")


@pytest.mark.parametrize("hw,HW", [((64, 64), (64, 64)), ((16, 16), (64, 64)),
                                   ((24, 40), (64, 100)), ((7, 5), (10, 12))])
def test_mask_loss_interpolate(hw, HW):
    """The GT mask is read at floor(i * H / h) computed in f32, on ratios
    that are and are not whole numbers."""
    rng = np.random.default_rng(7)
    seg = rng.standard_normal((B, *hw)).astype(np.float32)
    gt = (rng.random((B, *HW)) > 0.5).astype(np.float32)
    ref = float(jlosses.mask_loss_interpolate(jnp.asarray(seg), jnp.asarray(gt)))
    got = float(losses.mask_loss_interpolate(*_t(seg, gt)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_losses_give_gradients():
    logits, gt, mask = _t(*_inputs(8))
    logits.requires_grad_()
    losses.masked_code_loss(logits, gt, mask).backward()
    assert torch.isfinite(logits.grad).all()
    assert (logits.grad[mask[..., 0] == 0] == 0).all()   # nothing from outside the roi
