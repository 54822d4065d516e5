"""Training and eval steps (counterpart of checkerpose_tpu/train/steps.py).

Everything per-sample-expensive runs on the device inside a step: color
augmentation, ImageNet normalization, GT binary-code labels, forward, losses,
backward, optimizer update. The host only hands over uint8 crops and
projections.

A step is `step(state, batch, generator) -> metrics`. It runs eagerly and
updates `state.module` (parameters, BatchNorm statistics) and
`state.optimizer` in place; `batch` is a dict of tensors on the module's
device, `generator` a `torch.Generator` on that device from which every
random draw of the step is made, and `metrics` a dict of 0-d tensors still on
the device (read them with `float()` only when they are needed). The forward
and loss of each step are functions of their own (`pretrain_loss`,
`train_loss`), which is what the parity tests hold against the JAX package.

Loss structure:
  * pretrain: unmasked BCE on the RoI bit + masked BCE on the first res_log2
    x/y bits.
  * train: RoI + masked x/y over 3+stage bits + weighted visib/full seg mask
    L1, and the opt-in auxiliary terms.

Every pose step takes a static (N, K) graph or, for the multi-object
variant, the stacked (O, N, K) table of every object's graph, which
`knn_for_batch` gathers per sample by `batch["obj_idx"]`. The dense NOCS
step (`make_nocs_train_step`) pretrains a backbone with labels that
`nocs_labels` back-projects from a depth crop rendered on the device.

Under data parallelism (`state.mesh`, parallel/mesh.py, set by
`train/loop.py::run_training`) each rank holds its rows of the global batch
and a step computes what the one-process step computes on the concatenated
batch: every random draw (the colour augmentation, the teacher-forcing mask)
is made at the global batch's shape from a generator seeded alike on every
rank, each rank keeping its own rows; every loss is the rank's part of the
global loss (losses/__init__.py's `group`); BatchNorm takes global
statistics; `_update` sums the gradients over the ranks before the
optimizer, and the metrics come back summed, i.e. global. The all-reduce is
explicit rather than `DistributedDataParallel`: a curriculum stage leaves
the later stages' parameters out of the graph, which DDP meets only with
`find_unused_parameters` and a search of the graph every step, while here
every rank gives them a zero gradient and issues the same one collective.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from checkerpose_tpu_torch.losses import (global_mean, global_sum, mask_loss_interpolate,
                                          masked_code_loss, per_bit_masked_code_loss,
                                          unmasked_code_loss)
from checkerpose_tpu_torch.ops import augment, codes, geometry
from checkerpose_tpu_torch.ops.crop import normalize_image
from checkerpose_tpu_torch.ops.raster import face_chunks, render_depth_crops
from checkerpose_tpu_torch.parallel.mesh import all_sum_, rows
from checkerpose_tpu_torch.train.state import TrainState


def teacher_force_prob_at(step: int, base: float, anneal_start: int,
                          anneal_end: int) -> float:
    """Scheduled-sampling anneal of the teacher-forced refine conditioning:
    linear decay from `base` (steps <= anneal_start) to 0 (steps >=
    anneal_end). anneal_end <= anneal_start disables the anneal. The
    probability is fixed per built step, so a run that rebuilds its steps on
    resume follows the schedule piecewise."""
    if base <= 0.0 or anneal_end <= anneal_start:
        return base
    frac = (step - anneal_start) / float(anneal_end - anneal_start)
    return base * min(1.0, max(0.0, 1.0 - frac))


def finebit_bit_weights(cfg, step: int, active_bits: int):
    """Resolve the fine-bit loss-boost cfg keys to a per-bit weight tuple
    (or None = parity) at resume `step`.

    Keys (all opt-in): finebit_loss_boost_weight, the weight of bits >=
    finebit_boost_start_bit (default 4, 0-based MSB-first; coarser bits keep
    1.0), active from finebit_boost_start_step (default
    refine_teacher_force_anneal_end) on."""
    boost = float(cfg.get("finebit_loss_boost_weight", 0.0) or 0.0)
    start_bit = int(cfg.get("finebit_boost_start_bit", 4))
    start_step = int(cfg.get("finebit_boost_start_step",
                             cfg.get("refine_teacher_force_anneal_end", 0)))
    if boost <= 0.0 or step < start_step or active_bits <= start_bit:
        return None
    return tuple(1.0 if j < start_bit else boost for j in range(active_bits))


def knn_for_batch(knn_idx, batch):
    """Single-object: the static (N, K) graph, returned as it is.
    Multi-object: the stacked (O, N, K) table, on the device, indexed by
    `batch["obj_idx"]` (B,) -> the per-sample (B, N, K) graph each EdgeConv
    gathers with (the JAX package's `jnp.take` over the objects)."""
    if knn_idx.dim() == 3:
        return knn_idx.index_select(0, batch["obj_idx"].to(knn_idx.device).long())
    if knn_idx.dim() != 2:
        raise ValueError(f"knn_idx must be (N, K) or (O, N, K), got {tuple(knn_idx.shape)}")
    return knn_idx


def device_labels(batch: Dict[str, torch.Tensor], crop_size_gt: int):
    """GT labels from projections + final bbox, on the device: roi_bit
    (B, N, 1) f32, x_id / y_id (B, N) int32 at crop_size_gt resolution."""
    roi_bit, x_id, y_id = geometry.make_code_labels(batch["proj_xy"], batch["bbox"],
                                                    crop_size_gt)
    return roi_bit[..., None], x_id, y_id


def continuous_rel_coords(batch: Dict[str, torch.Tensor], crop_size_gt: int):
    """Continuous (un-truncated) keypoint coordinates in GT-crop cells:
    `make_code_labels`' geometry minus the trunc. x_rel / y_rel (B, N) f32."""
    bbox = batch["bbox"]
    px, py, _ = geometry.crop_cell_sizes(bbox, crop_size_gt)
    proj = batch["proj_xy"]
    return (proj[..., 0] - bbox[:, 0:1]) / px, (proj[..., 1] - bbox[:, 1:2]) / py


def _coord_reg_loss(x_logits, y_logits, x_rel, y_rel, roi_bit, active_bits: int,
                    res_log2: int, group=None):
    """Coordinate-space L1 between the sigmoid-expected id, E[id] = sum
    sigmoid(l_i) 2^(L-1-i), and the continuous GT coordinate at the
    active-bit resolution minus 0.5 (ids floor to the cell corner), masked by
    the in-RoI bit and normalized by the active resolution."""
    L = active_bits
    w = 2.0 ** torch.arange(L - 1, -1, -1, dtype=torch.float32, device=x_logits.device)
    ex = (torch.sigmoid(x_logits.float()) * w).sum(-1)
    ey = (torch.sigmoid(y_logits.float()) * w).sum(-1)
    scale = 2.0 ** (res_log2 - active_bits)       # GT cells per active-bit cell
    tx = x_rel / scale - 0.5
    ty = y_rel / scale - 0.5
    m = roi_bit[..., 0]
    n = global_sum(m.sum(), group).clamp_min(1.0)
    res = 2.0 ** active_bits
    return (((ex - tx).abs() * m).sum() + ((ey - ty).abs() * m).sum()) / (2.0 * n * res)


def device_augment_normalize(images_u8, generator, use_pepper_salt, use_motion_blur,
                             train: bool, color_aug_prob: float = 0.8, mesh=None):
    """uint8 (B, H, W, 3) crops -> augmented (train and color_aug_prob > 0
    only) and ImageNet-normalized f32. Under a mesh the augmentation is drawn
    for the global batch and this rank applies its own rows' draws."""
    imgs = images_u8.to(torch.float32)
    if train and color_aug_prob > 0:
        B, H, W, _ = imgs.shape
        world = 1 if mesh is None else mesh.world
        params = augment.draw_color_augment(generator, B * world, H, W, use_pepper_salt,
                                            use_motion_blur, color_aug_prob)
        imgs = augment.apply_color_augment(imgs, augment.rows_of(params, rows(B, mesh)))
    return normalize_image(imgs)


def _masked_cell_ce(resp, cell, m, group=None):
    """Softmax-CE of (B, N, HW) response maps at the GT cell, masked by m
    (B, N) and normalized by clamp(sum(m), 1)."""
    ce = F.cross_entropy(resp.float().flatten(0, 1), cell.flatten().long(),
                         reduction="none").view_as(m)
    return (ce * m).sum() / global_sum(m.sum(), group).clamp_min(1.0)


def _aux_heatmap_loss(resp, roi_bit, x_id, y_id, total_bits: int, group=None):
    """Auxiliary dense supervision of the init net's per-keypoint 8x8
    response maps: softmax-CE at the GT cell (row-major), masked by the
    in-RoI bit. resp (B, N, 64); x_id / y_id at 2**total_bits resolution."""
    shift = total_bits - 3
    cell = (y_id >> shift) * 8 + (x_id >> shift)
    return _masked_cell_ce(resp, cell, roi_bit[..., 0], group)


def _aux_refine_loss(out, roi_bit, x_id, y_id, res_log2: int, stage: int, group=None):
    """Dense supervision of the UpBlock maps at every active refine
    resolution: the mean over stages of the softmax-CE of
    out["refine_resp_{i}"] (B, N, HW) at the GT cell, masked by in-RoI."""
    total = 0.0
    for i in range(stage):
        r = 4 + i                       # up_i output is 2**(4+i) square
        shift = res_log2 - r
        cell = (y_id >> shift) * (1 << r) + (x_id >> shift)
        total = total + _masked_cell_ce(out[f"refine_resp_{i}"], cell, roi_bit[..., 0],
                                        group)
    return total / stage


def _code_labels_bits(x_id, y_id, total_bits: int, use_bits: int):
    """ids at 2**total_bits resolution -> their first `use_bits` MSB code
    planes (B, N, use_bits) f32."""
    xc = codes.ids_to_codes(x_id, total_bits)[..., :use_bits].float()
    yc = codes.ids_to_codes(y_id, total_bits)[..., :use_bits].float()
    return xc, yc


def _check_training(state: TrainState, net):
    if state.module is not net:
        raise ValueError("the step was built for another module than state.module")
    if not net.training:
        raise RuntimeError("a train step needs the module in train mode: call "
                           "state.module.train() (train/loop.py does after each eval)")


def _update(state: TrainState, total):
    """Backward of `total` and one optimizer update, in place. A parameter
    the loss does not reach (a refine stage beyond the curriculum's, an
    unused backbone branch) gets a zero gradient rather than none, so that
    Adam counts its updates from the first step on as optax does; torch's
    Adam would otherwise start that parameter's bias correction at the first
    step it sees a gradient. Under a process group the gradients, flattened
    into one tensor, are summed over the ranks before the update."""
    state.optimizer.zero_grad(set_to_none=False)
    total.backward()
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if state.mesh is not None and state.mesh.group is not None:
        flat = all_sum_(torch.cat([p.grad.reshape(-1) for p in params]), state.mesh)
        offset = 0
        for p in params:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
    state.optimizer.step()
    state.step += 1


def _batch_group(state: TrainState):
    return None if state.mesh is None else state.mesh.batch_group


def _reported(metrics, state: TrainState):
    """The metrics detached; under a process group summed over the ranks
    (each is a rank's part of a global value) in one all-reduce."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if _batch_group(state) is None:
        return metrics
    total = all_sum_(torch.stack([v.float() for v in metrics.values()]), state.mesh)
    return dict(zip(metrics, total.unbind()))


# ---------------------------------------------------------------------------
# pretrain (InitNet)
# ---------------------------------------------------------------------------

def pretrain_loss(net, knn_idx, imgs, batch, crop_size_gt: int, *, mask_loss_type="BCE",
                  proj_loss_type="BCE", proj_bit_loss_weight=1.0, aux_heatmap_weight=0.0,
                  group=None):
    """Forward of an InitNet on normalized NHWC `imgs` and the pretrain
    loss: (total, metrics). In train mode the forward updates the BatchNorm
    statistics. `group`: see losses/__init__.py."""
    total_bits = int(math.log2(crop_size_gt))
    res_log2 = net.res_log2
    roi_bit, x_id, y_id = device_labels(batch, crop_size_gt)
    gt_x, gt_y = _code_labels_bits(x_id, y_id, total_bits, res_log2)
    out_bits, _, _, resp = net(imgs.permute(0, 3, 1, 2), knn_for_batch(knn_idx, batch))
    l_roi = unmasked_code_loss(out_bits[..., 0:1], roi_bit, mask_loss_type, group)
    l_x = masked_code_loss(out_bits[..., 1:1 + res_log2], gt_x, roi_bit, proj_loss_type, group)
    l_y = masked_code_loss(out_bits[..., 1 + res_log2:], gt_y, roi_bit, proj_loss_type, group)
    total = l_roi + proj_bit_loss_weight * (l_x + l_y)
    metrics = {"loss": total, "loss_roi": l_roi, "loss_x": l_x, "loss_y": l_y}
    if aux_heatmap_weight:
        l_aux = _aux_heatmap_loss(resp, roi_bit, x_id, y_id, total_bits, group)
        total = total + aux_heatmap_weight * l_aux
        metrics.update(loss=total, loss_aux=l_aux)
    return total, metrics


def make_pretrain_step(net, knn_idx, crop_size_gt: int, *, mask_loss_type="BCE",
                       proj_loss_type="BCE", proj_bit_loss_weight=1.0,
                       use_pepper_salt=True, use_motion_blur=True, color_aug_prob=0.8,
                       aux_heatmap_weight=0.0):
    """Pretrain step of an InitNet; knn_idx (N, K) or stacked (O, N, K)
    int32 on the net's device (`knn_for_batch`)."""

    def step(state: TrainState, batch, generator):
        _check_training(state, net)
        imgs = device_augment_normalize(batch["image"], generator, use_pepper_salt,
                                        use_motion_blur, train=True,
                                        color_aug_prob=color_aug_prob, mesh=state.mesh)
        total, metrics = pretrain_loss(
            net, knn_idx, imgs, batch, crop_size_gt, mask_loss_type=mask_loss_type,
            proj_loss_type=proj_loss_type, proj_bit_loss_weight=proj_bit_loss_weight,
            aux_heatmap_weight=aux_heatmap_weight, group=_batch_group(state))
        _update(state, total)
        return _reported(metrics, state)

    return step


def make_init_eval_step(net, knn_idx, crop_size_gt: int):
    """Per-sample mask-bit accuracy, reprojection accuracy and per-bit
    errors of an InitNet in eval mode, on the device: `step(batch)` ->
    {acc_mask, acc_x, acc_y (B,), bit_err (B, 1+2L)}."""
    total_bits = int(math.log2(crop_size_gt))
    res_log2 = net.res_log2

    @torch.no_grad()
    def step(batch):
        if net.training:
            raise RuntimeError("the eval step needs the module in eval mode: call net.eval()")
        imgs = device_augment_normalize(batch["image"], None, False, False, train=False)
        roi_bit, x_id, y_id = device_labels(batch, crop_size_gt)
        gt_x, gt_y = _code_labels_bits(x_id, y_id, total_bits, res_log2)
        out_bits = net(imgs.permute(0, 3, 1, 2), knn_for_batch(knn_idx, batch))[0]
        pred = (out_bits > 0.0).float()
        m = roi_bit              # the GT mask, applied to predicted and GT codes alike
        dx = gt_x * m - pred[..., 1:1 + res_log2] * m                    # (B, N, L)
        dy = gt_y * m - pred[..., 1 + res_log2:] * m
        n_in_roi = m[..., 0].sum(1).clamp_min(1.0)                       # (B,)
        err_mask = (m - pred[..., 0:1]).abs().mean((1, 2))
        w = 2.0 ** (res_log2 - 1 - torch.arange(res_log2, dtype=torch.float32,
                                                device=out_bits.device))
        rex = (dx * w).sum(-1).abs().sum(1) / n_in_roi
        rey = (dy * w).sum(-1).abs().sum(1) / n_in_roi
        bit_err = torch.cat([err_mask[:, None], dx.abs().sum(1) / n_in_roi[:, None],
                             dy.abs().sum(1) / n_in_roi[:, None]], dim=1)
        return {"acc_mask": 1.0 - err_mask, "acc_x": 1.0 - rex / 2.0 ** res_log2,
                "acc_y": 1.0 - rey / 2.0 ** res_log2, "bit_err": bit_err}

    return step


# ---------------------------------------------------------------------------
# train (PoseNet)
# ---------------------------------------------------------------------------

def _prefix_correct_masks(out, gt_x, gt_y, sel, active_bits: int):
    """(B, N, L) mask: 1 for the init bits (< 3), and for refine bit j where
    all predicted x and y bits < j match GT (the conditioning cell of bit j)
    or the keypoint was teacher-forced. Carries no gradient."""
    eq_x = 1.0 - ((out["x_logits"].detach() > 0).float() - gt_x).abs()
    eq_y = 1.0 - ((out["y_logits"].detach() > 0).float() - gt_y).abs()
    ones = torch.ones_like(eq_x[..., :1])
    pre_x = torch.cat([ones, eq_x.cumprod(-1)[..., :-1]], dim=-1)
    pre_y = torch.cat([ones, eq_y.cumprod(-1)[..., :-1]], dim=-1)
    cell_ok = pre_x * pre_y
    if sel is not None:
        cell_ok = torch.maximum(cell_ok, sel.float()[..., None])
    j = torch.arange(active_bits, device=cell_ok.device)
    return torch.where(j < 3, 1.0, cell_ok).detach()


def train_loss(net, knn_idx, imgs, batch, stage: int, *, sel=None, roi_loss_type="BCE",
               proj_loss_type="BCE", seg_visib_loss_weight=1.0, seg_full_loss_weight=1.0,
               full_bits=False, aux_heatmap_weight=0.0, aux_refine_weight=0.0,
               coord_reg_weight=0.0, bit_weights: Optional[Sequence[float]] = None,
               prefix_correct_mask=False, group=None):
    """Forward of a PoseNet on normalized NHWC `imgs` and the train loss:
    (total, metrics). `sel` (B, N) bool, or None, marks the keypoints whose
    refine gathers are teacher-forced; the other options are
    `make_train_step`'s. In train mode the forward updates the BatchNorm
    statistics. `group`: see losses/__init__.py."""
    res_log2 = net.res_log2
    active_bits = res_log2 if full_bits else 3 + stage
    if bit_weights is not None and len(bit_weights) != active_bits:
        raise ValueError(f"bit_weights has {len(bit_weights)} entries for "
                         f"{active_bits} active bits")
    masks_on = prefix_correct_mask and not full_bits and active_bits > 3
    roi_bit, x_id, y_id = device_labels(batch, 2 ** res_log2)
    gt_x, gt_y = _code_labels_bits(x_id, y_id, res_log2, active_bits)
    # only PoseNet takes tf_gather; the woProg ablation has no refine gathers
    tf = {} if sel is None else {"tf_gather": (x_id, y_id, roi_bit, sel)}
    out = net(imgs, knn_for_batch(knn_idx, batch), batch["p3d_normed"], stage=stage, **tf)

    l_roi = unmasked_code_loss(out["roi_logit"], roi_bit, roi_loss_type, group)
    metrics = {}
    if bit_weights is not None or masks_on:
        bit_masks = None
        if masks_on:
            bit_masks = _prefix_correct_masks(out, gt_x, gt_y, sel, active_bits)
            # share of in-roi keypoints whose finest-bit conditioning cell is right
            metrics["finebit_sup_frac"] = (
                (bit_masks[..., -1] * roi_bit[..., 0]).sum()
                / global_sum(roi_bit[..., 0].sum(), group).clamp_min(1.0))
        l_x = per_bit_masked_code_loss(out["x_logits"], gt_x, roi_bit, bit_masks,
                                       bit_weights, proj_loss_type, group)
        l_y = per_bit_masked_code_loss(out["y_logits"], gt_y, roi_bit, bit_masks,
                                       bit_weights, proj_loss_type, group)
    else:
        l_x = masked_code_loss(out["x_logits"], gt_x, roi_bit, proj_loss_type, group)
        l_y = masked_code_loss(out["y_logits"], gt_y, roi_bit, proj_loss_type, group)
    l_sv = mask_loss_interpolate(out["seg_logits"][..., 0], batch["mask_visib"], group)
    l_sf = mask_loss_interpolate(out["seg_logits"][..., 1], batch["mask_full"], group)
    total = l_roi + l_x + l_y + seg_visib_loss_weight * l_sv + seg_full_loss_weight * l_sf
    metrics.update(loss_roi=l_roi, loss_x=l_x, loss_y=l_y, loss_seg_visib=l_sv,
                   loss_seg_full=l_sf)
    if aux_heatmap_weight:
        l_aux = _aux_heatmap_loss(out["resp_map"], roi_bit, x_id, y_id, res_log2, group)
        total = total + aux_heatmap_weight * l_aux
        metrics["loss_aux"] = l_aux
    if aux_refine_weight:
        l_ref = _aux_refine_loss(out, roi_bit, x_id, y_id, res_log2, stage, group)
        total = total + aux_refine_weight * l_ref
        metrics["loss_aux_refine"] = l_ref
    if coord_reg_weight:
        x_rel, y_rel = continuous_rel_coords(batch, 2 ** res_log2)
        l_coord = _coord_reg_loss(out["x_logits"], out["y_logits"], x_rel, y_rel, roi_bit,
                                  active_bits, res_log2, group)
        total = total + coord_reg_weight * l_coord
        metrics["loss_coord"] = l_coord
    metrics["loss"] = total
    return total, metrics


def make_train_step(net, knn_idx, stage: int, *, roi_loss_type="BCE", proj_loss_type="BCE",
                    seg_visib_loss_weight=1.0, seg_full_loss_weight=1.0,
                    use_pepper_salt=True, use_motion_blur=True, full_bits=False,
                    color_aug_prob=0.8, aux_heatmap_weight=0.0, aux_refine_weight=0.0,
                    teacher_force_prob=0.0, coord_reg_weight=0.0, bit_weights=None,
                    prefix_correct_mask=False):
    """Full-pipeline train step of a PoseNet (or PoseNetWoProg) at one
    curriculum stage; knn_idx (N, K) or stacked (O, N, K) int32 on the net's
    device (`knn_for_batch`).

    full_bits: labels span the full code width at every stage.
    aux_heatmap_weight / aux_refine_weight: weights of `_aux_heatmap_loss` /
    `_aux_refine_loss` (the latter needs the net built with
    aux_refine_heads=True).
    teacher_force_prob: per-keypoint probability of teacher-forced refine
    conditioning (PoseNet.forward's tf_gather); 0 = reference parity.
    coord_reg_weight: weight of `_coord_reg_loss`.
    bit_weights: optional length-`active_bits` per-bit x/y loss weights.
    prefix_correct_mask: supervise each refine bit (index >= 3) only at
    keypoints whose predicted conditioning cell matches the GT cell, plus the
    teacher-forced ones."""
    if aux_refine_weight and not net.aux_refine_heads:
        raise ValueError("aux_refine_weight needs a PoseNet built with aux_refine_heads=True")
    if bit_weights is not None:
        bit_weights = tuple(float(w) for w in bit_weights)

    def step(state: TrainState, batch, generator):
        _check_training(state, net)
        imgs = device_augment_normalize(batch["image"], generator, use_pepper_salt,
                                        use_motion_blur, train=True,
                                        color_aug_prob=color_aug_prob, mesh=state.mesh)
        sel = None
        if teacher_force_prob > 0:
            B, N = batch["proj_xy"].shape[:2]
            world = 1 if state.mesh is None else state.mesh.world
            sel = torch.rand(B * world, N, generator=generator,
                             device=generator.device)[rows(B, state.mesh)] < teacher_force_prob
        total, metrics = train_loss(
            net, knn_idx, imgs, batch, stage, sel=sel, roi_loss_type=roi_loss_type,
            proj_loss_type=proj_loss_type, seg_visib_loss_weight=seg_visib_loss_weight,
            seg_full_loss_weight=seg_full_loss_weight, full_bits=full_bits,
            aux_heatmap_weight=aux_heatmap_weight, aux_refine_weight=aux_refine_weight,
            coord_reg_weight=coord_reg_weight, bit_weights=bit_weights,
            prefix_correct_mask=prefix_correct_mask, group=_batch_group(state))
        _update(state, total)
        return _reported(metrics, state)

    return step


def make_pose_forward(net, knn_idx, stage: int):
    """Inference forward of a PoseNet in eval mode: `fwd(batch)` with uint8
    crops -> hard ids + masks + seg probabilities."""

    @torch.no_grad()
    def fwd(batch):
        if net.training:
            raise RuntimeError("the inference forward needs the module in eval mode: "
                               "call net.eval()")
        imgs = device_augment_normalize(batch["image"], None, False, False, train=False)
        out = net(imgs, knn_for_batch(knn_idx, batch), batch["p3d_normed"], stage=stage)
        seg = torch.sigmoid(out["seg_logits"])
        return {"roi_mask": (out["roi_logit"][..., 0] > 0.0).float(),
                "x_id": out["x_id"], "y_id": out["y_id"],
                "x_logits": out["x_logits"], "y_logits": out["y_logits"],
                "seg_visib": seg[..., 0], "seg_full": seg[..., 1]}

    return fwd


# ---------------------------------------------------------------------------
# dense NOCS pretraining (NOCSNet)
# ---------------------------------------------------------------------------

def nocs_labels(depth, mask_visib, bbox, cam_K, R, t, diameter: float):
    """Per-pixel NOCS targets from a depth crop, on its device.

    depth (B, S, S) at the crop grid, in t's unit (0 = none); mask_visib
    (B, S, S) {0, 1}; bbox (B, 4) the final square crop; cam_K, R (B, 3, 3);
    t (B, 3). Each cell centre is back-projected, u = w / S (g + 0.5) + x,
    P = K^-1 [u, v, 1] z, to model coordinates m = R^T (P - t), normalized
    as m / diameter + 0.5 (the object fits a cube of side diameter).
    Returns (nocs (B, S, S, 3) clipped to [0, 1], valid (B, S, S) f32 where
    z > 0 and the mask is set)."""
    S = depth.shape[1]
    g = torch.arange(S, dtype=torch.float32, device=depth.device) + 0.5
    u = (bbox[:, 2:3] / S * g + bbox[:, 0:1])[:, None, :]          # (B, 1, S) along x
    v = (bbox[:, 3:4] / S * g + bbox[:, 1:2])[:, :, None]          # (B, S, 1) along y
    K = cam_K[:, :, :, None, None]
    X = (u - K[:, 0, 2]) * depth / K[:, 0, 0]
    Y = (v - K[:, 1, 2]) * depth / K[:, 1, 1]
    P = torch.stack([X, Y, depth], dim=-1)                          # (B, S, S, 3)
    m = torch.einsum("bji,bhwj->bhwi", R, P - t[:, None, None, :])
    valid = ((depth > 0) & (mask_visib > 0.5)).float()
    return (m / diameter + 0.5).clamp(0.0, 1.0), valid


def nocs_loss(net, imgs, batch, depth, diameter: float, visib_loss_weight: float = 0.5,
              group=None):
    """Forward of a NOCSNet on normalized NHWC `imgs` and its loss: the L1 of
    the 3 NOCS channels over the valid cells (normalized by 3 n) plus
    `visib_loss_weight` times the mean BCE of the visibility logit over the
    whole grid. (total, metrics). `group`: see losses/__init__.py."""
    gt, valid = nocs_labels(depth, batch["mask_visib"], batch["bbox"], batch["cam_K"],
                            batch["R"], batch["t"], diameter)
    out = net(imgs)
    n = global_sum(valid.sum(), group).clamp_min(1.0)
    l_nocs = ((out[..., :3] - gt).abs() * valid[..., None]).sum() / (3.0 * n)
    l_vis = global_mean(F.binary_cross_entropy_with_logits(
        out[..., 3], batch["mask_visib"], reduction="none"), group)
    total = l_nocs + visib_loss_weight * l_vis
    return total, {"loss": total, "loss_nocs": l_nocs, "loss_visib": l_vis}


def make_nocs_train_step(net, *, diameter: float, use_pepper_salt=True,
                         use_motion_blur=True, color_aug_prob=0.8,
                         visib_loss_weight: float = 0.5, mesh=None):
    """Dense NOCS pretraining step of a NOCSNet, with the pose steps' color
    augmentation and train-mode BatchNorm.

    mesh: (verts (V, 3), faces (F, 3)) of the object, put on the net's
    device when the step is built. When given, the step renders each
    sample's depth crop there (ops/raster.py) at the grid of
    `batch["mask_visib"]`; otherwise `batch["depth"]` carries it."""
    if mesh is not None:
        dev = next(net.parameters()).device
        verts = torch.as_tensor(np.asarray(mesh[0], np.float32), device=dev)
        chunks = face_chunks(mesh[1], dev)

    def depth_of(batch):
        if mesh is None:
            return batch["depth"]
        return render_depth_crops(verts, chunks, batch["R"], batch["t"], batch["cam_K"],
                                  batch["bbox"], batch["mask_visib"].shape[1])

    def step(state: TrainState, batch, generator):
        _check_training(state, net)
        imgs = device_augment_normalize(batch["image"], generator, use_pepper_salt,
                                        use_motion_blur, train=True,
                                        color_aug_prob=color_aug_prob, mesh=state.mesh)
        total, metrics = nocs_loss(net, imgs, batch, depth_of(batch), diameter,
                                   visib_loss_weight, _batch_group(state))
        _update(state, total)
        return _reported(metrics, state)

    return step
