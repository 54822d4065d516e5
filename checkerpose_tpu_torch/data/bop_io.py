"""BOP dataset index: walk scene directories into flat per-object manifests
(the port's copy of checkerpose_tpu/data/bop_io.py).

Equivalent of the reference's `bop_io.get_dataset` (`tools_for_BOP/bop_io.py:79`)
but emitting a flat list of Sample records instead of 13 parallel lists --
deterministic ordering, trivially shardable per host, and serializable to
JSON for reproducible input pipelines.

BOP directory layout walked here:
  <bop>/<dataset>/<folder>/<scene_id:06d>/
      scene_camera.json   {im_id: {cam_K (9,), depth_scale, ...}}
      scene_gt.json       {im_id: [{obj_id, cam_R_m2c (9,), cam_t_m2c (3,)}]}
      scene_gt_info.json  {im_id: [{bbox_obj, bbox_visib, visib_fract, ...}]}
      rgb/<im_id:06d>.png (or .jpg), mask/<im:06d>_<inst:06d>.png,
      mask_visib/<im:06d>_<inst:06d>.png
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Sample:
    rgb_path: str
    mask_path: str
    mask_visib_path: str
    scene_id: int
    im_id: int
    inst_id: int
    obj_id: int
    R: np.ndarray          # (3, 3)
    t: np.ndarray          # (3,)
    cam_K: np.ndarray      # (3, 3)
    bbox_visib: np.ndarray  # (4,) x y w h
    bbox_obj: np.ndarray    # (4,)
    visib_fract: float
    detect_bbox: Optional[np.ndarray] = None  # filled by attach_detections
    detect_score: float = -1.0
    # lm_imgn synthetic renders: masks derive from depth>0 at load time
    # (reference lm_dataset_pytorch.py:368-371); "syn" images get
    # unconditional background replacement during training (:380-381)
    depth_path: Optional[str] = None
    img_type: str = "real"
    depth_scale: float = 1.0  # scene_camera depth_scale (raw depth -> mm)


def _load_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def scan_bop_object(bop_dir: str, dataset: str, data_folder: str, obj_id: int,
                    visib_threshold: float = 0.1) -> List[Sample]:
    """All instances of `obj_id` in `<bop_dir>/<dataset>/<data_folder>` with
    visib_fract > threshold (reference filters identically,
    `bop_io.py:174-180`; test-time threshold is 0.1, train-time comes from
    cfg `train_obj_visible_theshold`)."""
    target_dir = os.path.join(bop_dir, dataset, data_folder)
    samples: List[Sample] = []
    if not os.path.isdir(target_dir):
        return samples
    for scene_name in sorted(os.listdir(target_dir)):
        scene_dir = os.path.join(target_dir, scene_name)
        cam_fn = os.path.join(scene_dir, "scene_camera.json")
        gt_fn = os.path.join(scene_dir, "scene_gt.json")
        info_fn = os.path.join(scene_dir, "scene_gt_info.json")
        if not (os.path.isfile(cam_fn) and os.path.isfile(gt_fn) and os.path.isfile(info_fn)):
            continue
        scene_id = int(scene_name)
        cams = _load_json(cam_fn)
        gts = _load_json(gt_fn)
        infos = _load_json(info_fn)
        for im_key in sorted(gts.keys(), key=int):
            im_id = int(im_key)
            # the .png path unless only a .jpg exists: a dataset written to a
            # frame cache alone (no image files) is keyed by the .png paths
            rgb = os.path.join(scene_dir, "rgb", f"{im_id:06d}.png")
            jpg = os.path.join(scene_dir, "rgb", f"{im_id:06d}.jpg")
            if not os.path.isfile(rgb) and os.path.isfile(jpg):
                rgb = jpg
            for inst, gt in enumerate(gts[im_key]):
                if int(gt["obj_id"]) != obj_id:
                    continue
                info = infos[im_key][inst]
                if info.get("visib_fract", 1.0) <= visib_threshold:
                    continue
                cam = cams[im_key]
                samples.append(Sample(
                    rgb_path=rgb,
                    mask_path=os.path.join(scene_dir, "mask", f"{im_id:06d}_{inst:06d}.png"),
                    mask_visib_path=os.path.join(scene_dir, "mask_visib", f"{im_id:06d}_{inst:06d}.png"),
                    scene_id=scene_id, im_id=im_id, inst_id=inst, obj_id=obj_id,
                    R=np.array(gt["cam_R_m2c"], np.float64).reshape(3, 3),
                    t=np.array(gt["cam_t_m2c"], np.float64).reshape(3),
                    cam_K=np.array(cam["cam_K"], np.float64).reshape(3, 3),
                    bbox_visib=np.array(info["bbox_visib"], np.float64),
                    bbox_obj=np.array(info.get("bbox_obj", info["bbox_visib"]), np.float64),
                    visib_fract=float(info.get("visib_fract", 1.0)),
                    depth_scale=float(cam.get("depth_scale", 1.0)),
                ))
    return samples


def scan_bop_targets(bop_dir: str, dataset: str, obj_id: int,
                     data_folder: str = "test") -> List[Sample]:
    """BOP-challenge test list: only (scene, im) pairs named in
    test_targets_bop19.json (reference `bop_io.get_bop_challange_test_data`,
    `bop_io.py:26-76`)."""
    targets = _load_json(os.path.join(bop_dir, dataset, "test_targets_bop19.json"))
    wanted = {(t["scene_id"], t["im_id"]) for t in targets if t["obj_id"] == obj_id}
    all_samples = scan_bop_object(bop_dir, dataset, data_folder, obj_id,
                                  visib_threshold=-1.0)
    return [s for s in all_samples if (s.scene_id, s.im_id) in wanted]


def load_models_info(bop_dir: str, dataset: str, eval_models: bool = False) -> dict:
    """models_info.json -> {obj_id: {diameter, min_*, size_*, symmetries...}}"""
    sub = "models_eval" if eval_models else "models"
    raw = _load_json(os.path.join(bop_dir, dataset, sub, "models_info.json"))
    return {int(k): v for k, v in raw.items()}


def model_ply_path(bop_dir: str, dataset: str, obj_id: int,
                   eval_models: bool = False) -> str:
    sub = "models_eval" if eval_models else "models"
    return os.path.join(bop_dir, dataset, sub, f"obj_{obj_id:06d}.ply")
