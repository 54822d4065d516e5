"""Pretrain a backbone on dense normalized object coordinates (NOCS)
(counterpart of checkerpose_tpu/cli/pretrain_backbone.py, same flags plus
`--device`):

  python -m checkerpose_tpu_torch.cli.pretrain_backbone --cfg <cfg> --obj_name ape [--device cpu]

A NOCSNet (models/nocs.py) trained by `train/steps.py::make_nocs_train_step`
in `train/loop.py::run_training` on the crop dataset at the head's stride-4
grid, its depth labels rendered on the device from the object's mesh at each
sample's pose and crop (ops/raster.py). The pretrain CLIs graft the result
into their init net through cfg `backbone_pretrain_checkpoint`
(cli/common.py::maybe_graft_pretrained_backbone). There is no pose metric
here, so the eval reports test_acc 0. Runs on the card unless `--device cpu`
(or cfg `device`) says otherwise; data-parallel under torchrun (see
cli/train.py).
"""
from __future__ import annotations

import argparse

import torch

from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.data.bop_io import model_ply_path, scan_bop_object
from checkerpose_tpu_torch.data.dataset import CropDataset, Loader
from checkerpose_tpu_torch.data.ply import load_ply_mesh
from checkerpose_tpu_torch.models.nocs import NOCSNet
from checkerpose_tpu_torch.parallel.mesh import local_batch_size, make_mesh, shard_manifest
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.loop import run_training
from checkerpose_tpu_torch.train.state import create_init_state, make_optimizer, param_count
from checkerpose_tpu_torch.utils.logging import MetricWriter


def build_nocs_net(cfg, dtype=torch.bfloat16) -> NOCSNet:
    return NOCSNet(backbone_name=cfg.get("network_backbone_name", "hrnet_w18"),
                   head_width=int(cfg.get("nocs_head_width", 128)), dtype=dtype)


def create_nocs_state(net: NOCSNet, optimizer, *, seed=0, device="cuda"):
    """A NOCSNet ready to train on `device`: the InitNet factory's rule
    (Flax initialisers drawn from `seed`, train mode)."""
    return create_init_state(net, optimizer, seed=seed, device=device)


def main(cfg):
    """Pretrain as cfg says; returns the final TrainState."""
    mesh = make_mesh(cfg.get("device", "cuda"))
    dev = mesh.device
    xyz, _, _ = common.load_keypoints(cfg)
    crop_img = int(cfg.get("BoundingBox_CropSize_image", 256))
    # labels live on the head's stride-4 grid, not at the pose codes' GT size
    crop_gt = crop_img // 4
    net = build_nocs_net(cfg)
    state = create_nocs_state(net, make_optimizer(float(cfg["learning_rate"])), device=dev)
    print(f"#parameters: {param_count(net):.2f}M", flush=True)

    ckpt = CheckpointManager(cfg["check_point_path"], mesh=mesh)
    if cfg.get("load_checkpoint", False) and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        print(f"resumed from step {state.step}", flush=True)

    verts, faces = load_ply_mesh(model_ply_path(cfg["bop_path"], cfg["dataset_name"],
                                                cfg["obj_id"]))
    if faces is None or len(faces) == 0:
        raise ValueError("NOCS pretraining renders GT depth from the mesh; "
                         "the model ply has no faces")
    samples = scan_bop_object(cfg["bop_path"], cfg["dataset_name"],
                              cfg["training_data_folder"], cfg["obj_id"],
                              float(cfg.get("train_obj_visible_theshold", 0.1)))
    loader = Loader(CropDataset(shard_manifest(samples, mesh.rank, mesh.world), xyz,
                                is_train=True, **common.crop_kw(cfg, crop_gt)),
                    local_batch_size(int(cfg["batch_size"]), mesh), shuffle=True, infinite=True)
    step = steps.make_nocs_train_step(
        net, diameter=common.object_diameter(cfg),
        use_pepper_salt=bool(cfg.get("use_peper_salt", True)),
        use_motion_blur=bool(cfg.get("use_motion_blur", True)),
        color_aug_prob=float(cfg.get("color_aug_prob", 0.8)),
        mesh=(verts, faces))

    writer = MetricWriter(cfg["tensorboard_path"]) if mesh.lead else None
    state = run_training(
        state=state, step_fns={None: step}, loader=loader,
        total_iteration=int(cfg["total_iteration"]), eval_fn=lambda module: {"test_acc": 0.0},
        ckpt=ckpt, writer=writer,
        log_freq=int(cfg.get("log_freq", 100)),
        test_freq=int(cfg.get("test_freq", 10 ** 9)),
        save_freq=int(cfg.get("save_freq", 0)) or None,
        mesh=mesh)
    if writer is not None:
        writer.close()
    return state


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dense NOCS backbone pretrain (GPU)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--obj_name", required=True)
    p.add_argument("--load_checkpoint", action="store_true")
    p.add_argument("--total_iteration", type=int, default=None)
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs without a card")
    return p.parse_args(argv)


def cfg_from_args(args):
    return common.resolve_cfg(args.cfg, args.obj_name, {
        "load_checkpoint": args.load_checkpoint or None,
        "total_iteration": args.total_iteration,
        "save_freq": args.save_freq,
        "batch_size": args.batch_size,
        "device": args.device,
    })


if __name__ == "__main__":
    main(cfg_from_args(parse_args()))
