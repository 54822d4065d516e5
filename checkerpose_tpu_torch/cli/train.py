"""Train the full progressive pose network on one object (counterpart of
checkerpose_tpu/cli/train.py, same flags plus `--device`):

  python -m checkerpose_tpu_torch.cli.train --cfg <cfg.txt> --obj_name ape [--device cpu]

A PoseNet whose init net starts from the latest pretrain checkpoint under
<init_pretrained_root>/<obj_name> (`cli/pretrain.py`), trained stage by stage
(`stage_start_steps_str`) by `train/steps.py::make_train_step` in
`train/loop.py::run_training`, and evaluated every `test_freq` steps by
`eval/harness.py::evaluate_pipeline` under the visib filter, the best
checkpoint gated on 1 - mean per-bit error. The per-run decisions follow the
JAX CLI: teacher forcing annealed at the resume step, the prefix-correct
fine-bit mask and the fine-bit loss boost switched on at their steps. Runs on
the card unless `--device cpu` (or cfg `device`) says otherwise.

Data-parallel over W cards of a node (NCCL; gloo with `--device cpu`), the
batch size staying the global one (parallel/mesh.py):

  torchrun --nproc_per_node W -m checkerpose_tpu_torch.cli.train --cfg <cfg.txt> --obj_name ape

The same holds for the other training CLIs (pretrain, pretrain_lm, train_lm,
pretrain_backbone). Without torchrun's environment the CLI runs one process.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.cli.pretrain import cfg_from_args, print_bit_err
from checkerpose_tpu_torch.cli.pretrain import parse_args as parse_training_args
from checkerpose_tpu_torch.config import get_train_stage, stage_start_steps
from checkerpose_tpu_torch.eval.harness import evaluate_pipeline
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.posenet import PoseNet, knn_tensor
from checkerpose_tpu_torch.parallel.mesh import make_mesh
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.loop import run_training
from checkerpose_tpu_torch.train.state import (TrainState, create_pose_state, make_optimizer,
                                               param_count)
from checkerpose_tpu_torch.utils.logging import MetricWriter


def build_pose_net(cfg, npoint: int, dtype=torch.bfloat16) -> PoseNet:
    """The PoseNet a config describes (compute in `dtype`)."""
    return PoseNet(
        npoint=npoint,
        aux_refine_heads=float(cfg.get("aux_refine_heatmap_weight", 0.0)) > 0,
        res_log2=int(cfg.get("network_res_log2", 6)),
        backbone_name=cfg.get("init_network_backbone_name", "resnet34"),
        local_k=int(cfg.get("network_local_k", 2)),
        leaky_slope=float(cfg.get("network_leaky_slope", 0.01)),
        num_graph_module=int(cfg.get("network_num_graph_module", 2)),
        graph_leaky_slope=float(cfg.get("network_graph_leaky_slope", 0.2)),
        init_num_conv1x1=int(cfg.get("init_network_num_conv1x1", 1)),
        init_num_graph_module=int(cfg.get("init_network_num_graph_module", 2)),
        init_graph_leaky_slope=float(cfg.get("init_network_graph_leaky_slope", 0.2)),
        dtype=dtype,
    )


def load_pretrained_init(cfg):
    """The pretrained InitNet's state_dict (on the CPU) from the latest
    checkpoint under <init_pretrained_root>/<obj_name> (the reference's
    `train.py:213-215` grafts the max-numbered checkpoint, not the best),
    else the best one; None, with a message, when neither exists."""
    root = cfg.get("init_pretrained_root")
    if not root:
        return None
    # single-object runs nest checkpoints under the object name; the
    # multi-object variant uses the shared "lm13" leaf
    ckpt_dir = os.path.join(root, cfg.get("obj_name", "lm13"))
    if not os.path.isdir(ckpt_dir):
        print(f"init_pretrained_root {ckpt_dir} missing; training from scratch")
        return None
    init_net = InitNet(
        npoint=2 ** int(cfg["num_p3d_log2"]),
        res_log2=3,
        backbone_name=cfg.get("init_network_backbone_name", "resnet34"),
        num_graph_module=int(cfg.get("init_network_num_graph_module", 2)),
        graph_leaky_slope=float(cfg.get("init_network_graph_leaky_slope", 0.2)))
    st = TrainState(module=init_net, optimizer=None)
    mgr = CheckpointManager(ckpt_dir)
    try:
        st = mgr.restore_eval(st)
    except FileNotFoundError:
        try:
            st = mgr.restore_eval(st, best=True)
        except FileNotFoundError:
            print(f"no init checkpoint under {ckpt_dir}; training from scratch")
            return None
    print(f"loaded pretrained init net from {ckpt_dir} (step {st.step})")
    return init_net.state_dict()


def stage_starts(cfg, num_refine_steps: int):
    """The steps at which each refine stage starts (all 0 when cfg names
    none), with the JAX CLI's warning when the first starts above 0."""
    starts = stage_start_steps(cfg) or tuple([0] * num_refine_steps)
    if starts and starts[0] > 0:
        print(f"WARNING: stage_start_steps {starts} begins >0; steps before "
              f"{starts[0]} run at stage 1, not 0 (the seg head needs one "
              "UpBlock; the reference's seg conv has the same constraint)", flush=True)
    return starts


def step_options(cfg, step: int, num_refine_steps: int, full_bits: bool = False,
                 res_log2: int = 6):
    """{stage: make_train_step options} fixed at `step` (the resume step):
    teacher forcing annealed there, the prefix-correct fine-bit mask on from
    prefix_correct_start_step, the fine-bit loss boost per stage. With
    full_bits (the woProg ablation, which emits all res_log2 bits at every
    stage and has no refine gathers) teacher forcing, the prefix mask and the
    aux refine loss are off and the boost spans res_log2 bits."""
    tf_base = 0.0 if full_bits else float(cfg.get("refine_teacher_force_prob", 0.0))
    tf_prob = steps.teacher_force_prob_at(
        step, tf_base, int(cfg.get("refine_teacher_force_anneal_start", 0)),
        int(cfg.get("refine_teacher_force_anneal_end", 0)))
    if tf_prob != tf_base:
        print(f"teacher forcing annealed {tf_base} -> {tf_prob:.3f} "
              f"(resume step {step})", flush=True)
    prefix_mask = (not full_bits
                   and bool(cfg.get("prefix_correct_finebit_mask", False))
                   and step >= int(cfg.get("prefix_correct_start_step", 0)))
    if prefix_mask:
        print(f"prefix-correct fine-bit masking ON (resume step {step})", flush=True)
    out = {}
    for stage in range(1, num_refine_steps + 1):
        bw = steps.finebit_bit_weights(cfg, step, res_log2 if full_bits else 3 + stage)
        if bw is not None and stage == num_refine_steps:
            print(f"fine-bit loss boost active: weights {bw}", flush=True)
        out[stage] = dict(
            bit_weights=bw, prefix_correct_mask=prefix_mask,
            roi_loss_type=cfg.get("RoiBit_Loss_Type", "BCE"),
            proj_loss_type=cfg.get("ProjBit_Loss_Type", "BCE"),
            seg_visib_loss_weight=float(cfg.get("seg_visib_loss_weight", 1.0)),
            seg_full_loss_weight=float(cfg.get("seg_full_loss_weight", 1.0)),
            use_pepper_salt=bool(cfg.get("use_peper_salt", True)),
            use_motion_blur=bool(cfg.get("use_motion_blur", True)),
            color_aug_prob=float(cfg.get("color_aug_prob", 0.8)),
            aux_heatmap_weight=float(cfg.get("aux_heatmap_loss_weight", 0.0)),
            aux_refine_weight=(0.0 if full_bits
                               else float(cfg.get("aux_refine_heatmap_weight", 0.0))),
            full_bits=full_bits, teacher_force_prob=tf_prob,
            coord_reg_weight=float(cfg.get("coord_reg_loss_weight", 0.0)))
    return out


def gated(rep):
    """Add the best-checkpoint gate to an eval report: 1 - mean per-bit
    error, which depends only on the hard predictions against the GT labels
    (adx10 under the cfg's decode mode moves with tau, so a gate on it goes
    stale when tau is retuned mid-run)."""
    if "bit_err" in rep:
        print_bit_err(rep["bit_err"])
        rep["gate_score"] = 1.0 - float(np.mean(rep["bit_err"]))
        rep["gate_metric"] = "one_minus_mean_bit_err"
    return rep


def main(cfg):
    """Train as cfg says; returns the final TrainState."""
    mesh = make_mesh(cfg.get("device", "cuda"))
    dev = mesh.device
    xyz, normed, knn_np = common.load_keypoints(cfg)
    net = build_pose_net(cfg, xyz.shape[0])
    opt = make_optimizer(float(cfg["learning_rate"]), cfg.get("learning_rate2"),
                         cfg.get("learning_rate2_start"))
    state = create_pose_state(net, opt, init_params=load_pretrained_init(cfg), device=dev)
    print(f"#parameters: {param_count(net):.2f}M", flush=True)

    ckpt = CheckpointManager(cfg["check_point_path"], mesh=mesh)
    if cfg.get("load_checkpoint", False) and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        print(f"resumed from step {state.step}", flush=True)

    knn = knn_tensor(knn_np, xyz.shape[0], dev)
    train_loader, val_loader_factory = common.build_train_loaders(cfg, xyz, mesh=mesh)
    starts = stage_starts(cfg, net.num_refine_steps)
    step_fns = {stage: steps.make_train_step(net, knn, stage=stage, **kw)
                for stage, kw in step_options(cfg, int(state.step),
                                              net.num_refine_steps).items()}

    writer = MetricWriter(cfg["tensorboard_path"]) if mesh.lead else None
    diameter = common.object_diameter(cfg)
    p3dn = normed.astype(np.float32)

    def eval_fn(module):
        return gated(evaluate_pipeline(
            module, knn, common.with_p3d(val_loader_factory(), p3dn), xyz, diameter,
            stage=module.num_refine_steps, use_adi=cfg.get("is_symmetric", False),
            filter_modes=("visib",), main_filter="visib",
            decode_mode=cfg.get("decode_mode", "hard"),
            decode_conf_tau=float(cfg.get("decode_conf_tau", 3.0))))

    state = run_training(
        state=state, step_fns=step_fns, loader=train_loader,
        total_iteration=int(cfg["total_iteration"]), eval_fn=eval_fn,
        ckpt=ckpt, writer=writer,
        log_freq=int(cfg.get("log_freq", 100)),
        test_freq=int(cfg.get("test_freq", 1000)),
        save_freq=int(cfg.get("save_freq", 0)) or None,
        get_stage=lambda s: max(1, get_train_stage(s, starts)),
        extra_batch=lambda batch: common.attach_p3d(batch, p3dn),
        mesh=mesh)
    if writer is not None:
        writer.close()
    return state


def parse_args(argv=None):
    return parse_training_args(argv, "train full pose net (GPU)")


if __name__ == "__main__":
    main(cfg_from_args(parse_args()))
