"""Pretrain the init localization network on one object (counterpart of
checkerpose_tpu/cli/pretrain.py, same flags plus `--device`):

  python -m checkerpose_tpu_torch.cli.pretrain --cfg <cfg.txt> --obj_name ape [--device cpu]

An InitNet trained by `train/steps.py::make_pretrain_step` in
`train/loop.py::run_training`, evaluated every `test_freq` steps on the
`val_folder` split by `eval/harness.py::evaluate_init`, with the best
checkpoint gated on its test_acc. Checkpoints go to
<check_point_path>/<cfg_name>/<obj_name>, where the train CLI's
`init_pretrained_root` finds them. Runs on the card unless `--device cpu` (or
cfg `device`) says otherwise; data-parallel under torchrun (see cli/train.py).
"""
from __future__ import annotations

import argparse

import torch

from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.eval.harness import evaluate_init
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.posenet import knn_tensor
from checkerpose_tpu_torch.parallel.mesh import make_mesh
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.loop import run_training
from checkerpose_tpu_torch.train.state import create_init_state, make_optimizer, param_count
from checkerpose_tpu_torch.utils.logging import MetricWriter


def build_init_net(cfg, npoint: int, dtype=torch.bfloat16) -> InitNet:
    """The InitNet a pretrain config describes (compute in `dtype`)."""
    return InitNet(
        npoint=npoint,
        res_log2=int(cfg.get("network_res_log2", 3)),
        backbone_name=cfg.get("network_backbone_name",
                              cfg.get("init_network_backbone_name", "resnet34")),
        num_conv1x1=int(cfg.get("network_num_conv1x1", 1)),
        num_graph_module=int(cfg.get("network_num_graph_module", 2)),
        graph_leaky_slope=float(cfg.get("network_graph_leaky_slope", 0.2)),
        dtype=dtype,
    )


def print_bit_err(be) -> None:
    """The per-bit error line (RoI, x MSB -> LSB, y MSB -> LSB). acc_x and
    acc_y are confidence-weighted reprojection accuracies and can read ~0.85
    while the raw bits are near chance; this line shows the bits."""
    L = (len(be) - 1) // 2
    print("  bit_err roi={:.3f} x=[{}] y=[{}]".format(
        be[0], " ".join(f"{v:.3f}" for v in be[1:1 + L]),
        " ".join(f"{v:.3f}" for v in be[1 + L:])), flush=True)


def main(cfg):
    """Pretrain as cfg says; returns the final TrainState."""
    mesh = make_mesh(cfg.get("device", "cuda"))
    dev = mesh.device
    xyz, normed, knn_np = common.load_keypoints(cfg)
    npoint = xyz.shape[0]
    net = build_init_net(cfg, npoint)
    crop_gt = int(cfg.get("BoundingBox_CropSize_GT", 128))

    state = create_init_state(net, make_optimizer(float(cfg["learning_rate"])), device=dev)
    print(f"#parameters: {param_count(net):.2f}M", flush=True)

    ckpt = CheckpointManager(cfg["check_point_path"], mesh=mesh)
    if cfg.get("load_checkpoint", False) and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        print(f"resumed from step {state.step}", flush=True)

    state = common.maybe_graft_pretrained_backbone(cfg, state)

    knn = knn_tensor(knn_np, npoint, dev)
    train_loader, val_loader_factory = common.build_train_loaders(cfg, xyz, mesh=mesh)
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
        rep = evaluate_init(module, knn, val_loader_factory(), crop_gt,
                            best_score_metric=cfg.get("best_score_metric"))
        if rep.get("bit_err") is not None:
            print_bit_err(rep["bit_err"])
        return rep

    state = run_training(
        state=state, step_fns={None: step}, loader=train_loader,
        total_iteration=int(cfg["total_iteration"]), eval_fn=eval_fn,
        ckpt=ckpt, writer=writer,
        log_freq=int(cfg.get("log_freq", 100)),
        test_freq=int(cfg.get("test_freq", 1000)),
        save_freq=int(cfg.get("save_freq", 0)) or None,
        mesh=mesh)
    if writer is not None:
        writer.close()
    return state


def parse_args(argv=None, description="pretrain init net (GPU)"):
    """The flags of the pretrain and train CLIs (the JAX CLIs' plus --device)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", required=True)
    p.add_argument("--obj_name", required=True)
    p.add_argument("--load_checkpoint", action="store_true")
    p.add_argument("--total_iteration", type=int, default=None)
    p.add_argument("--test_freq", type=int, default=None)
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs without a card")
    return p.parse_args(argv)


def cfg_from_args(args):
    return common.resolve_cfg(args.cfg, args.obj_name, {
        "load_checkpoint": args.load_checkpoint or None,
        "total_iteration": args.total_iteration,
        "test_freq": args.test_freq,
        "save_freq": args.save_freq,
        "batch_size": args.batch_size,
        "device": args.device,
    })


if __name__ == "__main__":
    main(cfg_from_args(parse_args()))
