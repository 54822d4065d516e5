"""Can the init net overfit a fixed batch? (counterpart of tools/diag_overfit.py)

    python -m checkerpose_tpu_torch.tools.diag_overfit [--backbone hrnet_w18]
        [--steps 3000] [--lr 2e-4] [--n 64] [--res_log2 3] [--f32] [--jitter]
        [--aux W] [--device cuda] [--root DIR] [--seed 0] [--log_every 200]

An InitNet (512 keypoints, K=20, bf16 unless --f32) trains with Adam on
`--n` fixed crops of the synthetic dataset of tools/gen_synth_scale.py,
without colour augmentation; at step 1, every `--log_every` steps and the
last step it prints the step's losses and the eval step's per-bit errors
(the RoI bit, then the x and the y bits, MSB first) on the same crops, in
the JAX tool's line. Healthy gradients drive the x/y bit errors well below
chance (0.5) on a memorizable set; with `--aux 1.0` (the auxiliary heatmap
loss) the JAX package's run reached an MSB error of 0.14 / 0.20 by step 400.

Without `--root` the fixture is written under `build/diag_overfit/` by the
port's generator with gen_synth_scale.py's arguments (seed 7, 1024
vertices), as many `train_real` images as the first `--n` samples need: the
generator draws in loop order, so these are the first `--n` samples of the
full dataset. `--root` reads an existing dataset instead (e.g. the one
gen_synth_scale.py writes). `run(args)` is the function behind the command
line; it returns the curve, the trained state and the batch.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.data.bop_io import scan_bop_object
from checkerpose_tpu_torch.data.dataset import CropDataset, _stack
from checkerpose_tpu_torch.data.framestore import FrameCache
from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.posenet import knn_tensor
from checkerpose_tpu_torch.ops._build import BUILD_DIR
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.state import TrainState, create_init_state, make_optimizer

# tools/gen_synth_scale.py's dataset: its generator arguments and the cfg the
# JAX tool reads it with
FIXTURE = dict(dataset="synth", n_objects=1, n_vertices=1024, seed=7)
CFG = {"dataset_name": "synth", "obj_id": 1, "fps_version": "fps_202212",
       "num_p3d_log2": 9, "network_graph_k": 20}
CROP_SIZE_GT = 128
VISIB_THRESHOLD = 0.2


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backbone", default="hrnet_w18")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--res_log2", type=int, default=3)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--jitter", action="store_true",
                   help="crop with the train-time bbox jitter (drawn once: the batch is fixed)")
    p.add_argument("--aux", type=float, default=0.0, help="aux heatmap loss weight")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--root", default=None,
                   help="an existing synthetic BOP root (default: write the fixture under "
                        "build/diag_overfit/)")
    p.add_argument("--seed", type=int, default=0, help="seed of the weights and the steps")
    p.add_argument("--log_every", type=int, default=200)
    return p.parse_args(argv)


def make_fixture(root: str, n: int) -> str:
    """The first `n` train_real images of gen_synth_scale.py's dataset under
    `root` (frame cache only), unless they are there already; returns root."""
    # the generator writes the frame cache's index last
    if not os.path.isfile(os.path.join(root, FIXTURE["dataset"], "frame_cache", "index.json")):
        make_synthetic_bop(root, n_scenes=1, folders={"train_real": n}, raw_cache=True,
                           write_png=False, **FIXTURE)
    return root


def load_batch(root: str, n: int, jitter: bool, crop_size_gt: int = CROP_SIZE_GT):
    """(batch of the first `n` samples as numpy arrays, keypoints xyz,
    normed, knn (512, 20)), cropped as the JAX tool crops them; the masks
    and labels at `crop_size_gt`."""
    xyz, normed, knn = common.load_keypoints(dict(CFG, bop_path=root))
    samples = scan_bop_object(root, "synth", "train_real", 1, VISIB_THRESHOLD)[:n]
    if len(samples) < n:
        raise ValueError(f"{root} holds {len(samples)} train_real samples, --n asks for {n}")
    cache_dir = os.path.join(root, "synth", "frame_cache")
    cache = FrameCache(cache_dir) if os.path.isfile(
        os.path.join(cache_dir, "index.json")) else None
    ds = CropDataset(samples, xyz, is_train=jitter, crop_size_img=256,
                     crop_size_gt=crop_size_gt, padding_ratio=1.5,
                     resize_method="crop_square_resize", seed=0, use_native=False,
                     frame_cache=cache)
    return _stack([ds[i] for i in range(len(samples))]), xyz, normed, knn


def _line(i: int, m: Dict[str, float], be: np.ndarray, s_per_step: float) -> str:
    L = (len(be) - 1) // 2
    return (f"step {i}: loss={m['loss']:.4f} roi={m['loss_roi']:.4f} "
            f"x={m['loss_x']:.4f} y={m['loss_y']:.4f} "
            f"| bit_err roi={be[0]:.3f} "
            f"x=[{' '.join(f'{v:.3f}' for v in be[1:1 + L])}] "
            f"y=[{' '.join(f'{v:.3f}' for v in be[1 + L:])}] "
            f"({s_per_step:.3f}s/step)")


def run(args: argparse.Namespace) -> Dict:
    """Train as the command line says. Returns {"curve": [{step, loss,
    loss_roi, loss_x, loss_y, (loss_aux), bit_err (1+2L,), s_per_step}, ...],
    "state": TrainState (module in train mode), "batch": numpy batch,
    "knn", "xyz", "normed", "root": the dataset's root}."""
    dev = resolve_device(args.device)
    root = args.root or make_fixture(str(BUILD_DIR / "diag_overfit" / f"n{args.n}"), args.n)
    batch, xyz, normed, knn = load_batch(root, args.n, bool(args.jitter))
    print(f"batch of {args.n} fixed crops; backbone={args.backbone} lr={args.lr} "
          f"res_log2={args.res_log2} f32={args.f32} device={dev}", flush=True)

    net = InitNet(npoint=xyz.shape[0], res_log2=args.res_log2, backbone_name=args.backbone,
                  dtype=torch.float32 if args.f32 else torch.bfloat16)
    state: TrainState = create_init_state(net, make_optimizer(args.lr), seed=args.seed,
                                          device=dev)
    knn_t = knn_tensor(knn, xyz.shape[0], dev)
    step = steps.make_pretrain_step(net, knn_t, CROP_SIZE_GT, color_aug_prob=0.0,
                                    aux_heatmap_weight=args.aux)
    eval_step = steps.make_init_eval_step(net, knn_t, CROP_SIZE_GT)
    on_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    curve: List[Dict] = []
    t0 = time.perf_counter()
    for i in range(1, args.steps + 1):
        metrics = step(state, on_dev, gen)
        if i == 1 or i % args.log_every == 0 or i == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            net.eval()
            be = eval_step(on_dev)["bit_err"].mean(0).cpu().numpy()
            net.train()
            s_per_step = (time.perf_counter() - t0) / i
            print(_line(i, m, be, s_per_step), flush=True)
            curve.append(dict(m, step=i, bit_err=be, s_per_step=s_per_step))
    return {"curve": curve, "state": state, "batch": batch, "knn": knn, "xyz": xyz,
            "normed": normed, "root": root}


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
