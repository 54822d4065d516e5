"""Evaluation harnesses (counterpart of checkerpose_tpu/eval/harness.py).

`evaluate_init` scores an InitNet's codes (the in-training eval of
pretraining); `evaluate_pipeline` runs the whole offline test: forward,
decode to correspondences under three filter modes (none / full mask /
visib mask), pose solve, ADD(-S) pass rates at 0.02 / 0.05 / 0.1 diameter,
rotation and translation errors, seg metrics, AUC; `calibrate_decode_tau`
sweeps the adaptive decode's tau on a held-out slice.

`knn_idx` is a static (N, K) graph or, for the multi-object variant, the
stacked (O, N, K) table of every object's graph; each batch then carries
`obj_idx`, the row of its sample's object. Everything per image runs batched
on the module's device; each batch comes back to the host in one copy, and
the host only aggregates. The module must be in eval mode (`net.eval()`).
The solver draws its hypotheses from one `torch.Generator` on the module's
device, seeded by `seed`, so a sweep is reproducible on one device (the JAX
package splits a PRNG key per batch; the two packages' draws differ).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.eval import metrics as M
from checkerpose_tpu_torch.eval.decode import adaptive_ids, ids_to_correspondences, soft_ids
from checkerpose_tpu_torch.models.posenet import knn_tensor
from checkerpose_tpu_torch.ops import codes as _codes
from checkerpose_tpu_torch.ops import geometry as _geom
from checkerpose_tpu_torch.solver.ransac import solve_poses_batched
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.utils.logging import span

FILTER_MODES = ("none", "full", "visib")

DEFAULT_TAU_GRID = (3.0, 4.0, 5.0, 6.0, 8.0)

_MODE_KEYS = ("adx02", "adx05", "adx10", "auc_posecnn", "mean_re_deg", "mean_te_mm",
              "rete2", "rete5", "re2", "re5", "te2", "te5", "n_valid_mean",
              "n_valid_lt6_frac")


def _module_device(net) -> torch.device:
    """The module's device, with the port's precision flags set for a card."""
    return resolve_device(next(net.parameters()).device)


def _graph(knn_idx, dev) -> torch.Tensor:
    """The static (N, K) graph, or the multi-object variant's stacked
    (O, N, K) table (gathered per sample by `obj_idx` in the steps), as int32
    on `dev`; a numpy graph is checked on the host, each table row against
    its own N."""
    if isinstance(knn_idx, torch.Tensor):
        return knn_idx.to(dev)
    knn = np.asarray(knn_idx)
    return knn_tensor(knn, knn.shape[-2], dev)


def _on(batch, keys, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(batch[k]), device=dev) for k in keys if k in batch}


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor of the dict in ONE device -> host copy, as float32
    (bools as 0/1): the batch's single synchronisation."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors.values()]).cpu().numpy()
    out, at = {}, 0
    for k, t in tensors.items():
        out[k] = flat[at:at + t.numel()].reshape(t.shape)
        at += t.numel()
    return out


def _bit_errors(x_id, y_id, roi_mask, proj_xy, bbox, res: int):
    """Per-bit code errors of the hard predictions vs GT labels, masked by
    the GT in-RoI bit: (B, 1 + 2 log2(res)), the RoI bit's error first."""
    L = int(math.log2(res))
    gt_bit, gt_x, gt_y = _geom.make_code_labels(proj_xy, bbox, res)
    m = gt_bit[:, :, None]
    n = gt_bit.sum(1).clamp_min(1.0)
    dxb = (_codes.ids_to_codes(x_id, L) - _codes.ids_to_codes(gt_x, L)).abs() * m
    dyb = (_codes.ids_to_codes(y_id, L) - _codes.ids_to_codes(gt_y, L)).abs() * m
    err_roi = (roi_mask - gt_bit).abs().mean(1)
    return torch.cat([err_roi[:, None], dxb.sum(1) / n[:, None], dyb.sum(1) / n[:, None]],
                     dim=1)


def evaluate_init(net, knn_idx, loader, crop_size_gt: int,
                  best_score_metric: Optional[str] = None) -> Dict[str, float]:
    """Mask-bit and code accuracies of an InitNet over `loader`; samples with
    valid=0 and the padding of the last batch are left out."""
    dev = _module_device(net)
    ev = steps.make_init_eval_step(net, _graph(knn_idx, dev), crop_size_gt)
    accs_mask, accs_x, accs_y, bit_errs = [], [], [], []
    for batch in loader:
        n_real = int(batch.get("n_real", len(batch["image"])))
        out = _to_host(ev(_on(batch, ("image", "proj_xy", "bbox", "obj_idx"), dev)))
        keep = np.asarray(batch.get("valid", np.ones(n_real)))[:n_real] > 0.5
        accs_mask.append(out["acc_mask"][:n_real][keep])
        accs_x.append(out["acc_x"][:n_real][keep])
        accs_y.append(out["acc_y"][:n_real][keep])
        bit_errs.append(out["bit_err"][:n_real][keep])
    if not accs_mask or not np.concatenate(accs_mask).size:
        # an empty or missing val split: a neutral zero score, not a crash
        return {"test_acc": 0.0, "acc_mask": 0.0, "acc_x": 0.0, "acc_y": 0.0,
                "bit_err": np.zeros(1 + 2 * net.res_log2), "n_images": 0}
    acc_mask = float(np.concatenate(accs_mask).mean())
    acc_x = float(np.concatenate(accs_x).mean())
    acc_y = float(np.concatenate(accs_y).mean())
    bit_err = np.concatenate(bit_errs).mean(axis=0)
    if best_score_metric is None:
        test_acc = acc_mask * 0.5 + acc_x * 0.25 + acc_y * 0.25
    elif best_score_metric == "mean_bit_acc":
        test_acc = 1.0 - float(bit_err.mean())
    else:
        raise ValueError(best_score_metric)
    return {"test_acc": test_acc, "acc_mask": acc_mask, "acc_x": acc_x,
            "acc_y": acc_y, "bit_err": bit_err}


def calibrate_decode_tau(net, knn_idx, loader_factory, p3d_xyz, diameter: float, *,
                         stage: int, taus=DEFAULT_TAU_GRID, main_filter: str = "visib",
                         **eval_kw):
    """Pick decode_conf_tau by sweeping a small held-out slice: adx10 under
    `main_filter` for each tau of `taus` on the slice `loader_factory()`
    gives; returns (best_tau, {tau: adx10}), ties to the smallest tau."""
    sweep = {}
    for tau in taus:
        rep = evaluate_pipeline(
            net, knn_idx, loader_factory(), p3d_xyz, diameter,
            stage=stage, filter_modes=(main_filter,), main_filter=main_filter,
            decode_mode="adaptive", decode_conf_tau=float(tau), **eval_kw)
        sweep[float(tau)] = rep[main_filter]["adx10"]
    best = min(sorted(sweep), key=lambda t: (-sweep[t], t))
    return best, sweep


def _filter_ids(out, res: int, filter_judge_bits: Optional[int]):
    """Ids the seg and boundary filters judge: the net's hard claim, or with
    filter_judge_bits = k the centre of its top-k-bit cell (so the noisy fine
    bits cannot decide the filter)."""
    fx, fy = out["x_id"], out["y_id"]
    if filter_judge_bits is not None:
        s = max(int(math.log2(res)) - int(filter_judge_bits), 0)
        if s > 0:
            half = (1 << s) // 2
            fx = (fx.to(torch.int32) >> s << s) + half
            fy = (fy.to(torch.int32) >> s << s) + half
    return fx, fy


def evaluate_pipeline(net, knn_idx, loader, p3d_xyz, diameter: float,
                      *, stage: int, use_adi: bool = False, vertices=None,
                      reproj_thresh: float = 2.0, num_hyp: int = 128,
                      soft_inlier_sigma: float = 0.0,
                      coherence_weight: float = 0.0,
                      neighborhood_radius: float = 20.0,
                      discard_bd_pixel: int = 0,
                      filter_modes=FILTER_MODES, main_filter: str = "visib",
                      sym_rots=None, seed: int = 0,
                      decode_mode: str = "hard",
                      decode_conf_tau: float = 3.0,
                      filter_judge_bits: Optional[int] = None,
                      spans: Optional[Dict[str, List[float]]] = None) -> Dict:
    """Full eval sweep: aggregate metrics + per-image poses for the CSV.

    p3d_xyz: (N, 3) keypoints (mm) for PnP; `vertices`: denser model points
    for ADD/ADI (default p3d_xyz). sym_rots: optional (K, 3, 3) discrete
    symmetries for the closest-symmetric rotation error. All filter modes
    share one forward and one stacked solver call per batch.

    spans: when a dict is given, the device is synchronised at each phase's
    end and each batch's host-clock seconds are appended to a list under
    "loader" (waiting for the batch), "forward_decode", "solver_metrics"
    (solve, errors, seg and bit metrics, the copy to the host) and
    "aggregate" (the host's bookkeeping). Under torch.profiler the same
    phases are the spans eval.forward_decode, eval.solver_metrics and
    eval.aggregate inside eval.batch, beside eval.loader
    (utils/logging.py); they synchronise nothing.
    """
    dev = _module_device(net)
    knn = _graph(knn_idx, dev)
    fwd = steps.make_pose_forward(net, knn, stage)
    res = 2 ** net.output_res_log2(stage)
    verts = torch.as_tensor(np.asarray(vertices if vertices is not None else p3d_xyz),
                            dtype=torch.float32, device=dev)
    p3d = torch.as_tensor(np.asarray(p3d_xyz), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    solver_kw = dict(num_hyp=num_hyp, reproj_thresh=reproj_thresh,
                     soft_inlier_sigma=soft_inlier_sigma, coherence_weight=coherence_weight,
                     neighborhood_radius=neighborhood_radius)
    eff_main = main_filter if main_filter in filter_modes else filter_modes[0]
    nm = len(filter_modes)

    def mark(name, t0):
        if spans is None:
            return t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        spans.setdefault(name, []).append(t1 - t0)
        return t1

    def decode(out, on):
        """Correspondences of the batch under every filter mode."""
        with span("decode", dev):
            if decode_mode == "soft":
                dec_x, dec_y = soft_ids(out["x_logits"], out["y_logits"])
            elif decode_mode == "adaptive":
                dec_x, dec_y = adaptive_ids(out["x_logits"], out["y_logits"], decode_conf_tau)
            else:
                dec_x, dec_y = out["x_id"], out["y_id"]
            fx, fy = _filter_ids(out, res, filter_judge_bits)
            p2d_all, valid_all = [], []
            for mode in filter_modes:
                seg = {"none": None, "full": out["seg_full"], "visib": out["seg_visib"]}[mode]
                p2d, valid = ids_to_correspondences(
                    dec_x, dec_y, out["roi_mask"], on["bbox"], crop_size_gt=res,
                    seg_mask=seg, check_seg=(mode != "none"),
                    discard_bd_pixel=discard_bd_pixel, filter_x_id=fx, filter_y_id=fy)
                p2d_all.append(p2d)
                valid_all.append(valid)
            return p2d_all, valid_all

    per_mode = {m: {"adx": [], "re": [], "te": [], "nvalid": []} for m in filter_modes}
    poses: List[Dict] = []
    seg_acc, seg_iou, bit_errs = [], [], []
    n_images = 0

    it = iter(loader)
    t = time.perf_counter()
    while True:
        with span("eval.loader", dev):
            batch = next(it, None)
        if batch is None:
            break
        t = mark("loader", t)
        with span("eval.batch", dev):
            with span("eval.forward_decode", dev):
                n_real = int(batch.get("n_real", len(batch["image"])))
                on = _on(batch, ("image", "p3d_normed", "obj_idx", "R", "t", "bbox",
                                 "cam_K", "proj_xy", "mask_visib"), dev)
                out = fwd(on)
                sample_valid = np.asarray(batch["valid"]) > 0.5
                B = on["R"].shape[0]
                p2d_all, valid_all = decode(out, on)
            t = mark("forward_decode", t)

            with span("eval.solver_metrics", dev):
                sol = solve_poses_batched(p3d, torch.cat(p2d_all), torch.cat(valid_all),
                                          on["cam_K"].repeat(nm, 1, 1), gen, device=dev,
                                          **solver_kw)
                errs = M.batched_pose_errors(sol["R"], sol["t"], on["R"].repeat(nm, 1, 1),
                                             on["t"].reshape(-1, 3).repeat(nm, 1), verts,
                                             use_adi=use_adi, sym_rots=sym_rots)
                found = {"R": sol["R"], "t": sol["t"], "success": sol["success"],
                         "adx": errs["adx"], "re": errs["re"], "te": errs["te"],
                         "nvalid": torch.stack([v.sum(1) for v in valid_all])}
                if "proj_xy" in on:
                    found["bit_err"] = _bit_errors(out["x_id"], out["y_id"], out["roi_mask"],
                                                   on["proj_xy"], on["bbox"], res)
                # seg metrics against the GT visib mask sampled at the stage resolution
                gt_mask = on["mask_visib"]
                h = out["seg_visib"].shape[1]
                idx = torch.div(torch.arange(h, device=dev) * gt_mask.shape[1], h,
                                rounding_mode="floor")
                found["seg_err"], found["seg_iou"] = M.batched_mask_metrics(
                    out["seg_visib"] > 0.5, gt_mask[:, idx][:, :, idx])
                host = _to_host(found)
            t = mark("solver_metrics", t)

            with span("eval.aggregate", dev):
                for mi, mode in enumerate(filter_modes):
                    sl = slice(mi * B, (mi + 1) * B)
                    ok = (host["success"][sl] > 0.5) & sample_valid
                    acc = per_mode[mode]
                    acc["adx"].append(np.where(ok, host["adx"][sl], np.inf)[:n_real])
                    acc["re"].append(np.where(ok, host["re"][sl], 180.0)[:n_real])
                    acc["te"].append(np.where(ok, host["te"][sl], np.inf)[:n_real])
                    acc["nvalid"].append(host["nvalid"][mi][:n_real])
                real_valid = sample_valid[:n_real]
                if "bit_err" in host:
                    bit_errs.append(host["bit_err"][:n_real][real_valid])
                seg_acc.extend((1.0 - host["seg_err"][:n_real][real_valid]).tolist())
                seg_iou.extend(host["seg_iou"][:n_real][real_valid].tolist())
                mi = filter_modes.index(eff_main)
                for b in range(n_real):
                    row = mi * B + b
                    solved = sample_valid[b] and host["success"][row] > 0.5
                    poses.append({
                        "scene_id": int(batch["scene_id"][b]),
                        "im_id": int(batch["im_id"][b]),
                        "R": host["R"][row], "t": host["t"][row],
                        "score": 1.0 if solved else -1.0,
                    })
                n_images += n_real
            t = mark("aggregate", t)

    report: Dict = {"n_images": n_images, "poses": poses}
    if n_images == 0:
        # empty test loader: a neutral report
        for mode in filter_modes:
            report[mode] = {k: 0.0 for k in _MODE_KEYS}
        report["seg_acc"] = report["seg_iou"] = 0.0
        report["test_acc"] = 0.0
        return report
    for mode in filter_modes:
        acc = {k: np.concatenate(v) for k, v in per_mode[mode].items()}
        errs = acc["adx"]
        res_m = {}
        for frac, name in ((0.02, "adx02"), (0.05, "adx05"), (0.10, "adx10")):
            res_m[name] = float((errs < frac * diameter).mean())
        res_m["auc_posecnn"] = M.compute_auc_posecnn(errs / 1000.0)
        re, te = acc["re"], acc["te"]
        res_m["mean_re_deg"] = float(np.mean(re))
        res_m["mean_te_mm"] = (float(np.mean(te[np.isfinite(te)])) if np.isfinite(te).any()
                               else float("inf"))
        res_m.update(M.rete_pass_rates(re, te))
        nv = acc["nvalid"]
        res_m["n_valid_mean"] = float(nv.mean())
        res_m["n_valid_lt6_frac"] = float((nv < 6).mean())
        report[mode] = res_m
    report["seg_acc"] = float(np.mean(seg_acc)) if seg_acc else 1.0
    report["seg_iou"] = float(np.mean(seg_iou)) if seg_iou else 1.0
    if bit_errs:
        report["bit_err"] = np.concatenate(bit_errs).mean(axis=0).tolist()
    report["test_acc"] = report[eff_main]["adx10"]
    return report
