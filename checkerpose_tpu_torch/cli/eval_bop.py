"""Score a BOP19 result CSV against BOP ground truth (counterpart of
checkerpose_tpu/cli/eval_bop.py, same arguments plus `--device`):

  python -m checkerpose_tpu_torch.cli.eval_bop --csv result.csv \
      --bop_path <bop> --dataset lmo [--split test] [--device cpu]

The reference's downstream scoring (`bop_toolkit/scripts/check_results_bop19.py`
+ `eval_bop19_pose.py` -> `eval_calc_errors.py` -> `eval_calc_scores.py`):
MSSD and MSPD of every estimate against every GT instance of its image,
batched on the card (`eval/bop_scores.py`), then official matching and the
average recall on the host, with VSD when the split has depth images and the
mesh has faces (depth rendered on the host by `eval/renderer.py`). Depth is
read through `data/imageio.py`, which needs no image library.
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from checkerpose_tpu_torch.data import imageio
from checkerpose_tpu_torch.data.bop_io import load_models_info, model_ply_path, scan_bop_object
from checkerpose_tpu_torch.data.ply import load_ply_mesh, load_ply_vertices
from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.eval import bop_scores as B


def _eval_images(gt_by_im, targets_ntop, obj_id):
    """(scene, im) keys to evaluate: only the targeted images when a BOP19
    targets file exists (official eval_calc_scores.py walks the targets, so
    untargeted test images stay out of the recall's denominator), else every
    image with GT."""
    if targets_ntop:
        return [k for k in gt_by_im if (k[0], k[1], obj_id) in targets_ntop]
    return list(gt_by_im)


def _gt_valid_official(gts, key, targets_ntop, obj_id):
    """Per-GT validity. BOP19 (visib_gt_min = -1): the inst_count most
    visible GT instances are valid (eval_calc_scores.py:228-238); without a
    targets file, the visib_fract > 0.1 rule."""
    if not targets_ntop:
        return [s.visib_fract > 0.1 for s in gts]
    n = int(targets_ntop.get((key[0], key[1], obj_id), 0))
    order = sorted(range(len(gts)), key=lambda i: gts[i].visib_fract, reverse=True)
    valid = [False] * len(gts)
    for i in order[:max(n, 0)]:
        valid[i] = True
    return valid


def _depth_path(rgb_path: str) -> str:
    dp = rgb_path.replace("/rgb/", "/depth/")
    return dp[:dp.rfind(".")] + ".png"


def _try_vsd(ests, gt_by_im, targets_ntop, obj_id, bop_path, dataset, minfo):
    """AR_VSD with official matching when test depth images and mesh faces
    exist, else None. The AR averages recall over the (tau, threshold) grid:
    taus 0.05..0.5 * diameter, thresholds 0.05..0.5, delta 15 mm (bop19)."""
    try:
        verts, faces = load_ply_mesh(model_ply_path(bop_path, dataset, obj_id, eval_models=True))
    except (OSError, ValueError):
        return None
    if len(faces) == 0:
        return None
    diameter = float(minfo[obj_id]["diameter"])

    # per-pair per-tau errors; rendered distance maps are cached per pose
    # within an image, so E estimates x G GTs render E + G maps, not 2 E G
    render_cache = {}
    ests_by_im = defaultdict(list)
    for ei, r in enumerate(ests):
        ests_by_im[(r["scene_id"], r["im_id"])].append(ei)
    pair_errs = {}  # (ei, gt_id) -> list per tau
    eval_keys = _eval_images(gt_by_im, targets_ntop, obj_id)
    for key in eval_keys:
        gts = gt_by_im[key]
        e_idx = ests_by_im.get(key, [])
        if not e_idx:
            continue
        raw = imageio.read_depth_png(_depth_path(gts[0].rgb_path))
        if raw is None:
            return None  # no depth for this split: VSD unavailable
        depth = raw.astype(np.float32) * gts[0].depth_scale
        for ei in e_idx:
            r = ests[ei]
            for gt_id, gt in enumerate(gts):
                pair_errs[(ei, gt_id)] = B.vsd_error(
                    r["R"], r["t"], gt.R, gt.t, depth, gt.cam_K, verts, faces, diameter,
                    render_cache=render_cache, est_key=("e", key, ei), gt_key=("g", key, gt_id))
        # no cache entry is hit across images: dropping them after each
        # image keeps memory flat on large splits
        render_cache.clear()

    recalls = []
    for ti in range(len(B.VSD_TAUS)):
        groups = []
        for key in eval_keys:
            gts = gt_by_im[key]
            g_e = [{"score": ests[ei]["score"],
                    "errors": {g: pair_errs[(ei, g)][ti] for g in range(len(gts))
                               if (ei, g) in pair_errs}}
                   for ei in ests_by_im.get(key, [])]
            # matching considers every estimate (official n_top = -1 for
            # bop19); inst_count limits only which GTs are valid
            groups.append({"ests": g_e,
                           "gt_valid": _gt_valid_official(gts, key, targets_ntop, obj_id),
                           "n_top": -1})
        recalls.append(B.official_average_recall(groups, np.arange(0.05, 0.51, 0.05)))
    return float(np.mean(recalls))


def _probe_im_width(gt_by_im, default: int = 640) -> int:
    """Image width for the MSPD thresholds ((5..50) * w/640 px,
    eval_calc_scores.py), from the first rgb file: its PNG header, or a
    decode where the file is no PNG and a codec imports; `default` when
    neither gives one."""
    for gts in gt_by_im.values():
        path = gts[0].rgb_path
        size = imageio.png_size(path)
        if size is not None:
            return int(size[0])
        img = (imageio.read_image(path)
               if os.path.isfile(path) and imageio.have_codec() else None)
        return int(img.shape[1]) if img is not None else default
    return default


def main(csv_path: str, bop_path: str, dataset: str, split: str = "test",
         max_verts: int = 4096, im_width: int = 0, device="cuda"):
    """The report {"per_object", "overall", "note"} (also printed as JSON);
    None when the CSV is malformed."""
    dev = resolve_device(device)
    problems = B.check_bop_results_csv(csv_path)
    if problems:
        print("CSV format problems:", problems[:10])
        return None
    rows = B.load_bop_results_csv(csv_path)
    by_obj = defaultdict(list)
    for r in rows:
        by_obj[r["obj_id"]].append(r)

    minfo = load_models_info(bop_path, dataset, eval_models=True)
    # per-target inst_count from the BOP19 targets file when there is one
    targets_ntop = {}
    try:
        with open(f"{bop_path}/{dataset}/test_targets_bop19.json") as f:
            for t in json.load(f):
                targets_ntop[(t["scene_id"], t["im_id"], t["obj_id"])] = int(t.get("inst_count", 0))
    except FileNotFoundError:
        pass

    per_obj = {}
    for obj_id, ests in sorted(by_obj.items()):
        gt_samples = scan_bop_object(bop_path, dataset, split, obj_id, visib_threshold=-1.0)
        # every GT instance of an image (multi-instance scenes keep all)
        gt_by_im = defaultdict(list)
        for s in gt_samples:
            gt_by_im[(s.scene_id, s.im_id)].append(s)
        verts = load_ply_vertices(model_ply_path(bop_path, dataset, obj_id, eval_models=True))
        if len(verts) > max_verts:
            verts = verts[np.random.default_rng(0).choice(len(verts), max_verts, replace=False)]
        sym_R, sym_t = B.sym_arrays(minfo[obj_id])
        diameter = float(minfo[obj_id]["diameter"])

        # errors of every estimate against every GT instance of the object
        # in its image (official eval_calc_errors semantics)
        pairs = []  # (est_idx, gt_id)
        Re, te, Rg, tg, Ks = [], [], [], [], []
        for ei, r in enumerate(ests):
            for gt_id, gt in enumerate(gt_by_im.get((r["scene_id"], r["im_id"]), [])):
                pairs.append((ei, gt_id))
                Re.append(r["R"]); te.append(r["t"])  # noqa: E702
                Rg.append(gt.R); tg.append(gt.t); Ks.append(gt.cam_K)  # noqa: E702
        if not pairs:
            continue
        errs = B.batched_bop_errors(*(np.stack(a).astype(np.float32) for a in (Re, te, Rg, tg, Ks)),
                                    verts.astype(np.float32), sym_R, sym_t, device=dev)
        errs = {k: v.double().cpu().numpy() for k, v in errs.items()}
        mssd_e = errs["mssd"] / diameter
        # official MSPD thresholds scale with the image width ((5..50) * w/640):
        # equivalently the pixel errors scale by 640/w (w from the rgb
        # headers unless im_width says): tless 720, itodd 1280, ...
        w_im = im_width or _probe_im_width(gt_by_im)
        mspd_e = errs["mspd"] * (640.0 / w_im)

        # official matching groups per (scene, im)
        est_errors = defaultdict(dict)   # est_idx -> {gt_id: (mssd_n, mspd)}
        for (ei, gt_id), em, ep in zip(pairs, mssd_e, mspd_e):
            est_errors[ei][gt_id] = (em, ep)
        groups_mssd, groups_mspd = [], []
        ests_by_im = defaultdict(list)
        for ei, r in enumerate(ests):
            ests_by_im[(r["scene_id"], r["im_id"])].append(ei)
        for key in _eval_images(gt_by_im, targets_ntop, obj_id):
            # official semantics (eval_calc_scores.py): only targeted images
            # count, the inst_count most visible GTs are valid, and matching
            # considers all estimates (n_top = -1)
            gt_valid = _gt_valid_official(gt_by_im[key], key, targets_ntop, obj_id)
            e_idx = ests_by_im.get(key, [])
            for groups, j in ((groups_mssd, 0), (groups_mspd, 1)):
                groups.append({"ests": [{"score": ests[ei]["score"],
                                         "errors": {g: e[j] for g, e in est_errors[ei].items()}}
                                        for ei in e_idx],
                               "gt_valid": gt_valid, "n_top": -1})

        ar_mssd = B.official_average_recall(groups_mssd, B.MSSD_THRESHOLDS)
        ar_mspd = B.official_average_recall(groups_mspd, B.MSPD_THRESHOLDS)
        ar_vsd = _try_vsd(ests, gt_by_im, targets_ntop, obj_id, bop_path, dataset, minfo)
        rec = {"ar_mssd": ar_mssd, "ar_mspd": ar_mspd, "n_estimates": len(ests),
               "n_gt": sum(len(v) for v in gt_by_im.values())}
        if ar_vsd is not None:
            rec["ar_vsd"] = ar_vsd
        per_obj[obj_id] = rec

    # the combined AR aggregates the same metrics for every object: when any
    # object lacks VSD (no depth or faces), every object's "ar" is the mean
    # of MSSD and MSPD, so per-object and overall numbers stay comparable
    have_vsd = bool(per_obj) and all("ar_vsd" in v for v in per_obj.values())
    for rec in per_obj.values():
        rec["ar"] = ((rec["ar_vsd"] + rec["ar_mssd"] + rec["ar_mspd"]) / 3.0
                     if have_vsd else 0.5 * (rec["ar_mssd"] + rec["ar_mspd"]))
    keys = ("ar_mssd", "ar_mspd", "ar") + (("ar_vsd",) if have_vsd else ())
    overall = ({k: float(np.mean([v[k] for v in per_obj.values()])) for k in keys}
               if per_obj else {})
    note = ("official BOP19 matching; AR = mean(VSD, MSSD, MSPD)" if have_vsd
            else "official BOP19 matching; VSD unavailable for >=1 object "
                 "(no test depth images or mesh faces on disk) -- AR "
                 "averages MSSD+MSPD only, uniformly for all objects")
    if not per_obj:
        note = "no CSV estimates matched any GT of the split; nothing scored"
    report = {"per_object": per_obj, "overall": overall, "note": note}
    print(json.dumps(report, indent=2))
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="score a BOP19 CSV (MSSD, MSPD, VSD AR)")
    p.add_argument("--csv", required=True)
    p.add_argument("--bop_path", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--im_width", type=int, default=0,
                   help="image width for MSPD scaling (0 = probe from rgb)")
    p.add_argument("--device", default="cuda",
                   help="torch device of MSSD and MSPD; 'cpu' runs without a card")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(a.csv, a.bop_path, a.dataset, a.split, im_width=a.im_width, device=a.device)
