"""Pretrain the multi-object (LM 13-object) init net (counterpart of
checkerpose_tpu/cli/pretrain_lm.py, same flags plus `--device`):

  python -m checkerpose_tpu_torch.cli.pretrain_lm --cfg <cfg.txt> [--device cpu]

One shared InitNet over every object of the config: each sample reads its
own object's KNN graph, gathered from the stacked (O, N, K) table by
`obj_idx` inside the step (`train/steps.py::knn_for_batch`). Evaluated every
`test_freq` steps by `eval/harness.py::evaluate_init` on each object's
`val_folder` split, averaged over the objects; checkpoints go to
<check_point_path>/<cfg_name>/lm13, where the LM train CLI's
`init_pretrained_root` finds them. The backbone graft of
`backbone_pretrain_checkpoint` runs at step 0. Runs on the card unless
`--device cpu` (or cfg `device`) says otherwise; data-parallel under torchrun
(see cli/train.py).
"""
from __future__ import annotations

import argparse

import numpy as np

from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.cli.pretrain import build_init_net
from checkerpose_tpu_torch.eval.harness import evaluate_init
from checkerpose_tpu_torch.models.posenet import knn_tensor
from checkerpose_tpu_torch.parallel.mesh import make_mesh
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.loop import run_training
from checkerpose_tpu_torch.train.state import create_init_state, make_optimizer, param_count
from checkerpose_tpu_torch.utils.logging import MetricWriter


def main(cfg):
    """Pretrain as cfg (from `common.resolve_cfg_lm`) says; returns the
    final TrainState."""
    mesh = make_mesh(cfg.get("device", "cuda"))
    dev = mesh.device
    p3d_table, _, knn_np = common.load_keypoints_lm(cfg)
    net = build_init_net(cfg, knn_np.shape[1])
    crop_gt = int(cfg.get("BoundingBox_CropSize_GT", 128))

    opt = make_optimizer(float(cfg["learning_rate"]), cfg.get("learning_rate2"),
                         cfg.get("learning_rate2_start"))
    state = create_init_state(net, opt, device=dev)
    print(f"#parameters: {param_count(net):.2f}M", flush=True)

    ckpt = CheckpointManager(cfg["check_point_path"], mesh=mesh)
    if cfg.get("load_checkpoint", False) and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        print(f"resumed from step {state.step}", flush=True)

    state = common.maybe_graft_pretrained_backbone(cfg, state)

    knn = knn_tensor(knn_np, knn_np.shape[1], dev)
    train_loader, val_loader_factory = common.build_train_loaders_lm(cfg, p3d_table, mesh=mesh)
    step = steps.make_pretrain_step(
        net, knn, crop_gt,
        mask_loss_type=cfg.get("MaskBit_Loss_Type", "BCE"),
        proj_loss_type=cfg.get("ProjBit_Loss_Type", "BCE"),
        proj_bit_loss_weight=float(cfg.get("proj_bit_loss_weight", 1.0)),
        use_pepper_salt=bool(cfg.get("use_peper_salt", True)),
        use_motion_blur=bool(cfg.get("use_motion_blur", True)),
        color_aug_prob=float(cfg.get("color_aug_prob", 0.8)),
        aux_heatmap_weight=float(cfg.get("aux_heatmap_loss_weight", 0.0)))

    writer = MetricWriter(cfg["tensorboard_path"]) if mesh.lead else None

    def eval_fn(module):
        # one sweep per object, then the mean over the objects (the
        # reference's test_network_with_test_data.py:667-676)
        accs = [evaluate_init(module, knn, val_loader_factory(obj_id), crop_gt,
                              best_score_metric=cfg.get("best_score_metric"))["test_acc"]
                for obj_id in sorted(cfg["obj_ids"])]
        return {"test_acc": float(np.mean(accs))}

    state = run_training(
        state=state, step_fns={None: step}, loader=train_loader,
        total_iteration=int(cfg["total_iteration"]), eval_fn=eval_fn,
        ckpt=ckpt, writer=writer,
        log_freq=int(cfg.get("log_freq", 1000)),
        test_freq=int(cfg.get("test_freq", 10000)),
        save_freq=int(cfg.get("save_freq", 0)) or None,
        mesh=mesh)
    if writer is not None:
        writer.close()
    return state


def parse_args(argv=None, description="pretrain LM multi-object init net (GPU)"):
    """The flags of the LM pretrain and train CLIs (the JAX CLIs' plus --device)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", required=True)
    p.add_argument("--load_checkpoint", action="store_true")
    p.add_argument("--total_iteration", type=int, default=None)
    p.add_argument("--test_freq", type=int, default=None)
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs without a card")
    return p.parse_args(argv)


def cfg_from_args(args):
    return common.resolve_cfg_lm(args.cfg, {
        "load_checkpoint": args.load_checkpoint or None,
        "total_iteration": args.total_iteration,
        "test_freq": args.test_freq,
        "save_freq": args.save_freq,
        "device": args.device,
    })


if __name__ == "__main__":
    main(cfg_from_args(parse_args()))
