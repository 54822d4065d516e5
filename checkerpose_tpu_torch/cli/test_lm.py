"""Offline evaluation of the LM multi-object estimator (counterpart of
checkerpose_tpu/cli/test_lm.py, same flags plus `--device`):

  python -m checkerpose_tpu_torch.cli.test_lm --cfg <cfg.txt> [--ckpt_dir <dir>] \
      [--adx_type visib] [--decode_mode adaptive] [--device cpu]

Restores the port's checkpoint (the best one, else the latest; `--use_latest`
for the latest) and sweeps every object's test split with the full stacked
graph table (each sample on its own object's graph, by `obj_idx`): the pass
rates under the `--adx_type` filter, re/te/rete @2/@5, the closest-symmetric
rotation error for symmetric objects, seg IoU and per-bit errors, then the
mean over the objects. `--decode_mode adaptive` without `--decode_conf_tau`
calibrates tau on small held-out slices of the first three objects
(`calib_folder`). Writes `report_lm_<cfg>.json` with `per_object`,
`average`, `bit_err` and `bit_err_per_object`. Runs on the card unless
`--device cpu` (or cfg `device`) says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.cli.train_lm import build_pose_net_lm
from checkerpose_tpu_torch.data.bop_io import load_models_info
from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.eval import metrics as M
from checkerpose_tpu_torch.eval.harness import (DEFAULT_TAU_GRID, calibrate_decode_tau,
                                                evaluate_pipeline)
from checkerpose_tpu_torch.models.posenet import knn_tensor
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.state import create_pose_state, make_optimizer

ADX_FILTERS = {"default": "none", "full": "full", "visib": "visib"}


def main(cfg):
    """Evaluate the checkpoint cfg names over every object and write the
    report; returns (per_object, average)."""
    dev = resolve_device(cfg.get("device", "cuda"))
    p3d_table, p3dn_stack, knn_np = common.load_keypoints_lm(cfg)
    npoint = p3dn_stack.shape[1]
    net, _ = build_pose_net_lm(cfg, npoint)
    state = create_pose_state(net, make_optimizer(1e-4), seed=None, device=dev)
    ckpt_dir = cfg.get("ckpt_dir") or cfg["check_point_path"]
    mgr = CheckpointManager(ckpt_dir)
    if cfg.get("use_latest"):
        state = mgr.restore_eval(state)
        print(f"loaded LATEST checkpoint step {state.step}")
    else:
        try:
            state = mgr.restore_eval(state, best=True)
        except FileNotFoundError:
            state = mgr.restore_eval(state)
        print(f"loaded checkpoint step {state.step}")
    net.eval()
    knn = knn_tensor(knn_np, npoint, dev)
    res = 2 ** net.res_log2

    sorted_ids = sorted(cfg["obj_ids"])
    id_to_name = {oid: n for n, oid in zip(cfg["obj_names"], cfg["obj_ids"])}
    minfo = load_models_info(cfg["bop_path"], cfg["dataset_name"])
    main_filter = ADX_FILTERS[cfg.get("adx_type", "default")]
    p3dn = p3dn_stack.astype(np.float32)

    def cfg_of(obj_id):
        return dict(cfg, obj_id=obj_id)

    decode_mode = cfg.get("decode_mode", "hard")
    tau = float(cfg.get("decode_conf_tau", 3.0))
    tau_sweep = None
    if decode_mode == "adaptive" and cfg.get("decode_tau_auto"):
        # no tau given: calibrate on small held-out slices of the first
        # objects and average each tau's adx10 over them
        per_tau = {float(t): [] for t in DEFAULT_TAU_GRID}
        calib_ids = sorted_ids[:3]
        for obj_id in calib_ids:
            factory = common.build_val_slice_loader_factory(
                cfg_of(obj_id), dict(p3d_table), max_images=16, crop_gt=res)
            _, sweep = calibrate_decode_tau(
                net, knn, lambda f=factory: common.with_p3d(f(), p3dn),
                p3d_table[obj_id], float(minfo[obj_id]["diameter"]),
                stage=net.num_refine_steps,
                use_adi=id_to_name[obj_id] in cfg["symmetric_names"],
                main_filter="visib" if main_filter == "none" else main_filter,
                **common.solver_kwargs(cfg))
            for t, v in sweep.items():
                per_tau[t].append(v)
        tau_sweep = {t: float(np.mean(v)) for t, v in per_tau.items()}
        tau = min(tau_sweep, key=lambda t: (-tau_sweep[t], t))
        print(f"auto-calibrated decode_conf_tau={tau} (mean adx10 over "
              f"{len(calib_ids)} objects: {tau_sweep})", flush=True)

    per_obj, bit_errs = {}, {}
    for obj_id in sorted_ids:
        name = id_to_name[obj_id]
        # the whole table: CropDataset gives each sample its obj_idx row
        loader, _ = common.build_test_loader(
            cfg_of(obj_id), dict(p3d_table),
            batch_size=int(cfg.get("test_batch_size", 16)), crop_gt=res)
        sym_rots = None
        if name in cfg["symmetric_names"]:
            # the identity comes first, so a symmetric set has more than one
            syms = M.symmetry_transformations(minfo[obj_id])
            if len(syms) > 1:
                sym_rots = np.stack([R for R, _ in syms])
        r = evaluate_pipeline(
            net, knn, common.with_p3d(loader, p3dn), p3d_table[obj_id],
            float(minfo[obj_id]["diameter"]), stage=net.num_refine_steps,
            use_adi=name in cfg["symmetric_names"],
            # only the main filter is reported here
            filter_modes=(main_filter,), main_filter=main_filter, sym_rots=sym_rots,
            decode_mode=decode_mode, decode_conf_tau=tau,
            filter_judge_bits=cfg.get("filter_judge_bits"), **common.solver_kwargs(cfg))
        per_obj[name] = dict(r[main_filter], seg_iou=r["seg_iou"])
        if "bit_err" in r:
            bit_errs[name] = r["bit_err"]
        print(name, json.dumps(per_obj[name]))

    avg = {k: float(np.mean([v[k] for v in per_obj.values()]))
           for k in next(iter(per_obj.values()))}
    out_dir = cfg.get("eval_output_path", "eval_output")
    os.makedirs(out_dir, exist_ok=True)
    full = {"per_object": per_obj, "average": avg, "decode_mode": decode_mode}
    if decode_mode == "adaptive":
        full["decode_conf_tau"] = tau
        if tau_sweep is not None:
            full["tau_sweep"] = tau_sweep
    if bit_errs:
        full["bit_err"] = np.mean(list(bit_errs.values()), axis=0).tolist()
        full["bit_err_per_object"] = bit_errs
    with open(os.path.join(out_dir, f"report_lm_{cfg['config_file_name']}.json"), "w") as f:
        json.dump(full, f, indent=2)
    print("AVERAGE:", json.dumps(avg, indent=2))
    return per_obj, avg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate LM multi-object estimator (GPU)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--ckpt_file", default=None,
                   help="reference-CLI alias for --ckpt_dir")
    p.add_argument("--eval_output_path", default=None)
    p.add_argument("--use_progressivex", action="store_true")
    p.add_argument("--prog_max_iters", type=int, default=None)
    p.add_argument("--nbr_ball_radius", type=float, default=None)
    p.add_argument("--spatial_coherence_weight", type=float, default=None)
    p.add_argument("--adx_type", default=None, choices=[None, *ADX_FILTERS])
    p.add_argument("--decode_mode", default=None, choices=[None, "hard", "soft", "adaptive"])
    p.add_argument("--decode_conf_tau", type=float, default=None)
    p.add_argument("--filter_judge_bits", type=int, default=None,
                   help="judge seg/boundary filters at the top-k-bit cell center")
    p.add_argument("--use_latest", action="store_true",
                   help="evaluate the latest rolling checkpoint, not best")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs without a card")
    return p.parse_args(argv)


def cfg_from_args(args):
    return common.resolve_cfg_lm(args.cfg, {
        "ckpt_dir": common.checkpoint_dir_arg(args.ckpt_dir, args.ckpt_file),
        "eval_output_path": args.eval_output_path,
        "use_progressivex": args.use_progressivex or None,
        "prog_max_iters": args.prog_max_iters,
        "nbr_ball_radius": args.nbr_ball_radius,
        "spatial_coherence_weight": args.spatial_coherence_weight,
        "adx_type": args.adx_type,
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
