"""Offline evaluation + BOP CSV export for one object (counterpart of
checkerpose_tpu/cli/test.py, same flags and outputs):

  python -m checkerpose_tpu_torch.cli.test --cfg <cfg.txt> --obj_name ape \
      [--ckpt_dir <dir>] [--use_progressivex] [--eval_output_path out/] [--device cpu]

Restores the port's own checkpoints (`train/checkpoint.py`: the best one,
else the latest; `--use_latest` for the latest), evaluates the test split
with `eval/harness.py` and writes `score_<cfg>_<obj>.txt`,
`report_<cfg>_<obj>.json` and the BOP19 CSV `<cfg>_<obj>.csv`. Runs on the
card unless `--device cpu` (or cfg `device`) says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.cli.train import build_pose_net
from checkerpose_tpu_torch.data.bop_io import model_ply_path
from checkerpose_tpu_torch.data.ply import load_ply_vertices
from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.eval.csv_writer import write_csv
from checkerpose_tpu_torch.eval.harness import calibrate_decode_tau, evaluate_pipeline
from checkerpose_tpu_torch.models.posenet import knn_tensor
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.state import create_pose_state, make_optimizer


def main(cfg, spans=None):
    """Evaluate the checkpoint cfg names and write the outputs; returns the
    report. `spans`: see `evaluate_pipeline` (the test split's sweep only)."""
    dev = resolve_device(cfg.get("device", "cuda"))
    xyz, normed, knn = common.load_keypoints(cfg)
    npoint = xyz.shape[0]
    net = build_pose_net(cfg, npoint)
    state = create_pose_state(net, make_optimizer(1e-4), seed=None, device=dev)

    ckpt_dir = cfg.get("ckpt_dir") or cfg["check_point_path"]
    mgr = CheckpointManager(ckpt_dir)
    if cfg.get("use_latest"):
        state = mgr.restore_eval(state)
        print(f"loaded LATEST checkpoint (step {state.step}) from {ckpt_dir}")
    else:
        try:
            state = mgr.restore_eval(state, best=True)
            print(f"loaded BEST checkpoint (step {state.step}) from {ckpt_dir}")
        except FileNotFoundError:
            state = mgr.restore_eval(state)
            print(f"loaded latest checkpoint (step {state.step}) from {ckpt_dir}")
    net.eval()
    knn = knn_tensor(knn, npoint, dev)

    res = 2 ** net.res_log2
    loader, _ = common.build_test_loader(
        cfg, xyz, batch_size=int(cfg.get("test_batch_size", 16)), crop_gt=res)

    # ADD/ADI over eval-model vertices when available (8192 of them at most,
    # the JAX package's draw), else the keypoints
    try:
        verts = load_ply_vertices(model_ply_path(cfg["bop_path"], cfg["dataset_name"],
                                                 cfg["obj_id"], eval_models=True))
        if len(verts) > 8192:
            verts = verts[np.random.default_rng(0).choice(len(verts), 8192, False)]
    except (OSError, ValueError):
        verts = xyz
    diameter = common.object_diameter(cfg)
    p3dn = normed.astype(np.float32)

    # poses exported to the BOP CSV are unfiltered, except for the
    # reference's per-object list that uses the visib-mask filter
    use_filter_visib = (
        (cfg["dataset_name"] == "lmo"
         and cfg["obj_name"] in ("can", "cat", "driller", "eggbox"))
        or (cfg["dataset_name"] == "ycbv"
            and cfg["obj_name"] in ("pudding_box", "foam_brick")))
    main_filter = cfg.get("main_filter") or ("visib" if use_filter_visib else "none")

    decode_mode = cfg.get("decode_mode", "hard")
    tau = float(cfg.get("decode_conf_tau", 3.0))
    tau_sweep = None
    if decode_mode == "adaptive" and cfg.get("decode_tau_auto"):
        # no tau given: calibrate it on a <= 32-image held-out slice
        factory = common.build_val_slice_loader_factory(cfg, xyz, crop_gt=res)
        tau, tau_sweep = calibrate_decode_tau(
            net, knn, lambda: common.with_p3d(factory(), p3dn), xyz, diameter,
            stage=net.num_refine_steps, use_adi=cfg.get("is_symmetric", False),
            main_filter=("visib" if main_filter == "none" else main_filter),
            **common.solver_kwargs(cfg))
        print(f"auto-calibrated decode_conf_tau={tau} "
              f"(val-slice adx10 sweep: {tau_sweep})", flush=True)

    report = evaluate_pipeline(
        net, knn, common.with_p3d(loader, p3dn), xyz, diameter,
        stage=net.num_refine_steps, use_adi=cfg.get("is_symmetric", False),
        vertices=verts.astype(np.float32),
        **common.solver_kwargs(cfg),
        discard_bd_pixel=int(cfg.get("ignore_bit", 0)),
        main_filter=main_filter,
        decode_mode=decode_mode,
        decode_conf_tau=tau,
        filter_judge_bits=cfg.get("filter_judge_bits"),
        spans=spans)
    report["decode_mode"] = decode_mode
    if cfg.get("filter_judge_bits") is not None:
        report["filter_judge_bits"] = int(cfg["filter_judge_bits"])
    if decode_mode == "adaptive":
        report["decode_conf_tau"] = tau
        if tau_sweep is not None:
            report["tau_sweep"] = tau_sweep

    out_dir = cfg.get("eval_output_path", "eval_output")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{cfg['config_file_name']}_{cfg['obj_name']}"
    with open(os.path.join(out_dir, f"score_{tag}.txt"), "w") as f:
        for mode in ("none", "full", "visib"):
            if mode in report:
                f.write(f"[{mode}] " + " ".join(
                    f"{k}={v:.4f}" for k, v in report[mode].items()) + "\n")
        f.write(f"seg_acc={report['seg_acc']:.4f} seg_iou={report['seg_iou']:.4f}\n")
        f.write(f"test_acc={report['test_acc']:.4f}\n")
    with open(os.path.join(out_dir, f"report_{tag}.json"), "w") as f:
        json.dump({k: v for k, v in report.items() if k != "poses"}, f, indent=2)
    poses = report["poses"]
    write_csv(out_dir, tag, cfg["obj_id"],
              [p["scene_id"] for p in poses], [p["im_id"] for p in poses],
              [p["R"] for p in poses], [p["t"] for p in poses],
              [p["score"] for p in poses])
    print(json.dumps({k: v for k, v in report.items() if k != "poses"}, indent=2))
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate pose net + export BOP CSV (GPU)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--obj_name", required=True)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--ckpt_file", default=None,
                   help="reference-CLI alias for --ckpt_dir")
    p.add_argument("--eval_output_path", default=None)
    p.add_argument("--use_progressivex", action="store_true")
    p.add_argument("--prog_max_iters", type=int, default=None)
    p.add_argument("--cv_max_iters", type=int, default=None)
    p.add_argument("--nbr_ball_radius", type=float, default=None)
    p.add_argument("--spatial_coherence_weight", type=float, default=None)
    p.add_argument("--reprojErr_thresh", type=float, default=None)
    p.add_argument("--ignore_bit", type=int, default=None)
    p.add_argument("--test_batch_size", type=int, default=None)
    p.add_argument("--decode_mode", default=None,
                   choices=("hard", "soft", "adaptive"))
    p.add_argument("--decode_conf_tau", type=float, default=None)
    p.add_argument("--filter_judge_bits", type=int, default=None,
                   help="judge seg/boundary filters at the top-k-bit cell "
                        "center; default = reference parity (full-res hard claim)")
    p.add_argument("--use_latest", action="store_true",
                   help="evaluate the latest rolling checkpoint, not best")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs without a card")
    return p.parse_args(argv)


def cfg_from_args(args):
    return common.resolve_cfg(args.cfg, args.obj_name, {
        "ckpt_dir": common.checkpoint_dir_arg(args.ckpt_dir, args.ckpt_file),
        "eval_output_path": args.eval_output_path,
        "use_progressivex": args.use_progressivex or None,
        "prog_max_iters": args.prog_max_iters,
        "cv_max_iters": args.cv_max_iters,
        "nbr_ball_radius": args.nbr_ball_radius,
        "spatial_coherence_weight": args.spatial_coherence_weight,
        "reprojErr_thresh": args.reprojErr_thresh,
        "ignore_bit": args.ignore_bit,
        "test_batch_size": args.test_batch_size,
        "decode_mode": args.decode_mode,
        "decode_conf_tau": args.decode_conf_tau,
        "filter_judge_bits": args.filter_judge_bits,
        # --decode_mode adaptive without --decode_conf_tau: calibrate tau
        "decode_tau_auto": (args.decode_mode == "adaptive"
                            and args.decode_conf_tau is None) or None,
        "use_latest": args.use_latest or None,
        "device": args.device,
    })


if __name__ == "__main__":
    main(cfg_from_args(parse_args()))
