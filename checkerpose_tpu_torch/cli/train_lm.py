"""Train the full progressive network across the LM objects (counterpart of
checkerpose_tpu/cli/train_lm.py, same flags plus `--device`):

  python -m checkerpose_tpu_torch.cli.train_lm --cfg <cfg.txt> [--device cpu]

One shared PoseNet over every object of the config, each sample on its own
object's KNN graph (the stacked (O, N, K) table gathered by `obj_idx` in the
step), its init net from the latest pretrain checkpoint under
<init_pretrained_root>/lm13 (`cli/pretrain_lm.py`). The two-phase learning
rate (learning_rate -> learning_rate2 at learning_rate2_start), the stage
schedule and the per-run decisions of `cli/train.py` (teacher forcing
annealed at the resume step, the prefix-correct mask, the fine-bit weights).
Every `test_freq` steps each object's validation split is evaluated under
the visib filter; the run prints the per-object adx10 and the
object-averaged per-bit errors, and gates the best checkpoint on
1 - mean(bit_err). `network_type = vanilla_GNNskip_ABwoProg` selects the
no-progressive-localization ablation (models/ablation.py), trained on the
full code width at every stage. Runs on the card unless `--device cpu` (or
cfg `device`) says otherwise; data-parallel under torchrun (see cli/train.py).
"""
from __future__ import annotations

import numpy as np
import torch

from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.cli.pretrain import print_bit_err
from checkerpose_tpu_torch.cli.pretrain_lm import cfg_from_args
from checkerpose_tpu_torch.cli.pretrain_lm import parse_args as parse_training_args
from checkerpose_tpu_torch.cli.train import load_pretrained_init, stage_starts, step_options
from checkerpose_tpu_torch.config import get_train_stage
from checkerpose_tpu_torch.data.bop_io import load_models_info
from checkerpose_tpu_torch.eval.harness import evaluate_pipeline
from checkerpose_tpu_torch.models.ablation import PoseNetWoProg
from checkerpose_tpu_torch.models.posenet import PoseNet, knn_tensor
from checkerpose_tpu_torch.parallel.mesh import make_mesh
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.loop import run_training
from checkerpose_tpu_torch.train.state import create_pose_state, make_optimizer, param_count
from checkerpose_tpu_torch.utils.logging import MetricWriter

WOPROG = "vanilla_GNNskip_ABwoProg"


def build_pose_net_lm(cfg, npoint: int, dtype=torch.bfloat16):
    """(the network an LM config describes, full_bits): a PoseNet, or with
    `network_type = vanilla_GNNskip_ABwoProg` a PoseNetWoProg, whose labels
    span the full code width at every stage (full_bits True)."""
    kw = dict(
        npoint=npoint,
        res_log2=int(cfg.get("network_res_log2", 6)),
        backbone_name=cfg.get("init_network_backbone_name", "resnet34"),
        leaky_slope=float(cfg.get("network_leaky_slope", 0.01)),
        num_graph_module=int(cfg.get("network_num_graph_module", 2)),
        graph_leaky_slope=float(cfg.get("network_graph_leaky_slope", 0.2)),
        init_num_conv1x1=int(cfg.get("init_network_num_conv1x1", 1)),
        init_num_graph_module=int(cfg.get("init_network_num_graph_module", 2)),
        init_graph_leaky_slope=float(cfg.get("init_network_graph_leaky_slope", 0.2)),
        dtype=dtype,
    )
    if cfg.get("network_type", "vanilla_GNNskip") == WOPROG:
        return PoseNetWoProg(**kw), True
    return PoseNet(local_k=int(cfg.get("network_local_k", 2)),
                   aux_refine_heads=float(cfg.get("aux_refine_heatmap_weight", 0.0)) > 0,
                   **kw), False


def main(cfg):
    """Train as cfg (from `common.resolve_cfg_lm`) says; returns the final
    TrainState."""
    mesh = make_mesh(cfg.get("device", "cuda"))
    dev = mesh.device
    p3d_table, p3dn_stack, knn_np = common.load_keypoints_lm(cfg)
    npoint = p3dn_stack.shape[1]
    net, full_bits = build_pose_net_lm(cfg, npoint)
    opt = make_optimizer(float(cfg["learning_rate"]), cfg.get("learning_rate2"),
                         cfg.get("learning_rate2_start"))
    state = create_pose_state(net, opt, init_params=load_pretrained_init(cfg), device=dev)
    print(f"#parameters: {param_count(net):.2f}M", flush=True)

    ckpt = CheckpointManager(cfg["check_point_path"], mesh=mesh)
    if cfg.get("load_checkpoint", False) and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        print(f"resumed from step {state.step}", flush=True)

    knn = knn_tensor(knn_np, npoint, dev)
    train_loader, val_loader_factory = common.build_train_loaders_lm(cfg, p3d_table, mesh=mesh)
    starts = stage_starts(cfg, net.num_refine_steps)
    step_fns = {stage: steps.make_train_step(net, knn, stage=stage, **kw)
                for stage, kw in step_options(cfg, int(state.step), net.num_refine_steps,
                                              full_bits, net.res_log2).items()}

    writer = MetricWriter(cfg["tensorboard_path"]) if mesh.lead else None
    id_to_name = {oid: n for n, oid in zip(cfg["obj_names"], cfg["obj_ids"])}
    minfo = load_models_info(cfg["bop_path"], cfg["dataset_name"])
    p3dn = p3dn_stack.astype(np.float32)

    def eval_fn(module):
        accs, bit_errs = {}, []
        for obj_id in sorted(cfg["obj_ids"]):
            name = id_to_name[obj_id]
            r = evaluate_pipeline(
                module, knn, common.with_p3d(val_loader_factory(obj_id), p3dn),
                p3d_table[obj_id], float(minfo[obj_id]["diameter"]),
                stage=module.num_refine_steps, use_adi=name in cfg["symmetric_names"],
                filter_modes=("visib",), main_filter="visib",
                decode_mode=cfg.get("decode_mode", "hard"),
                decode_conf_tau=float(cfg.get("decode_conf_tau", 3.0)))
            accs[name] = r["test_acc"]
            if "bit_err" in r:
                bit_errs.append(r["bit_err"])
        print("per-object adx10:", {k: round(v, 4) for k, v in accs.items()})
        ev = {"test_acc": float(np.mean(list(accs.values())))}
        if bit_errs:
            print_bit_err(np.mean(np.asarray(bit_errs), axis=0))
        if len(bit_errs) == len(accs):
            # decode-invariant gate, as in cli/train.py: the mean per-bit
            # accuracy over every object
            ev["gate_score"] = 1.0 - float(np.mean([np.mean(b) for b in bit_errs]))
            ev["gate_metric"] = "one_minus_mean_bit_err"
        return ev

    state = run_training(
        state=state, step_fns=step_fns, loader=train_loader,
        total_iteration=int(cfg["total_iteration"]), eval_fn=eval_fn,
        ckpt=ckpt, writer=writer,
        log_freq=int(cfg.get("log_freq", 1000)),
        test_freq=int(cfg.get("test_freq", 10000)),
        save_freq=int(cfg.get("save_freq", 0)) or None,
        get_stage=lambda s: max(1, get_train_stage(s, starts)),
        extra_batch=lambda batch: common.attach_p3d(batch, p3dn),
        mesh=mesh)
    if writer is not None:
        writer.close()
    return state


def parse_args(argv=None):
    return parse_training_args(argv, "train LM multi-object pose net (GPU)")


if __name__ == "__main__":
    main(cfg_from_args(parse_args()))
