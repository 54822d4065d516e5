"""lm_imgn synthetic-render ingestion (the port's copy of
checkerpose_tpu/data/lm_imgn.py).

The reference's LM recipe mixes real LM images with lm_imgn synthetic renders
(`tools_for_LM/get_lm_datasets.py::get_imgn_dicts:175`): per object an index
file lists render ids, uniformly subsampled to n_per_obj (`:223-228`); each
render has `{id}-color.png`, `{id}-depth.png`, `{id}-pose.txt` and no mask
files -- the mask is depth > 0, computed at load time
(`lm_dataset_pytorch.py:368-371`). These samples carry img_type="syn" and get
a background in every training draw (`:380-381`). Depth PNGs are read with
`data/imageio.py::read_depth_png`, which needs no image library.

Layout expected under `root` (the reference's `lm_imgn` dir):
  <root>/imgn/<obj_name>/{id}-color.png, {id}-depth.png, {id}-pose.txt
  optional <root>/image_set/<something>_<obj_name>.txt index files; when
  absent, renders are globbed and sorted.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from checkerpose_tpu_torch.data.bop_io import Sample
from checkerpose_tpu_torch.data.imageio import read_depth_png

K_LM = np.array([[572.4114, 0.0, 325.2611],
                 [0.0, 573.57043, 242.04899],
                 [0.0, 0.0, 1.0]])

# DeepIM folder alias (reference get_lm_datasets.py:236-238)
_OBJ_ALIASES = {"benchvise": ("benchvise", "benchviseblue")}


def _read_pose(path: str):
    """{id}-pose.txt: a header line, then 3x4 [R|t] with t in meters
    (the reference's get_lm_datasets.py:254-257 multiplies t by 1000)."""
    pose = np.loadtxt(path, skiprows=1)
    return pose[:3, :3], pose[:3, 3] * 1000.0


def _mask_bbox(depth_path: str):
    """x, y, w, h of depth > 0; None when the file does not read or the
    mask covers fewer than 3 pixels (the reference's area filter,
    get_lm_datasets.py:269-271)."""
    depth = read_depth_png(depth_path)
    if depth is None:
        return None
    ys, xs = np.nonzero(depth > 0)
    if len(xs) < 3:
        return None
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], np.float64)


def scan_lm_imgn(root: str, obj_name: str, obj_id: int,
                 n_per_obj: int = 1000, cam_K: Optional[np.ndarray] = None,
                 scene_id: int = 1000) -> List[Sample]:
    """Flat Sample manifest over one object's imgn renders.

    Uniform (equal-space) subsample to n_per_obj ids, the reference's
    np.linspace selection (get_lm_datasets.py:223-228); n_per_obj <= 0 keeps
    them all. Samples carry depth_path instead of mask paths; CropDataset
    derives both masks from depth > 0. The box is the depth mask's.
    """
    K = np.asarray(cam_K if cam_K is not None else K_LM, np.float64)
    folders = _OBJ_ALIASES.get(obj_name, (obj_name,))
    obj_dir = None
    for f in folders:
        cand = os.path.join(root, "imgn", f)
        if os.path.isdir(cand):
            obj_dir = cand
            break
    if obj_dir is None:
        return []

    # the index file when present, else the sorted colour renders
    ids: List[str] = []
    for f in folders:
        for idx_path in sorted(glob.glob(os.path.join(root, "image_set", f"*{f}*.txt"))):
            with open(idx_path) as fh:
                ids.extend(line.strip().split()[-1].split("/")[-1]
                           for line in fh if line.strip())
        if ids:
            break
    if not ids:
        ids = sorted(os.path.basename(p)[:-len("-color.png")]
                     for p in glob.glob(os.path.join(obj_dir, "*-color.png")))
    if n_per_obj > 0 and len(ids) > n_per_obj:
        sel = np.linspace(0, len(ids) - 1, n_per_obj, dtype=np.int32)
        ids = [ids[int(i)] for i in sel]

    samples: List[Sample] = []
    for i, im_id in enumerate(ids):
        rgb = os.path.join(obj_dir, f"{im_id}-color.png")
        depth = os.path.join(obj_dir, f"{im_id}-depth.png")
        pose = os.path.join(obj_dir, f"{im_id}-pose.txt")
        if not (os.path.isfile(rgb) and os.path.isfile(depth) and os.path.isfile(pose)):
            continue
        bbox = _mask_bbox(depth)
        if bbox is None:
            continue
        R, t = _read_pose(pose)
        samples.append(Sample(
            rgb_path=rgb, mask_path="", mask_visib_path="",
            scene_id=scene_id, im_id=i, inst_id=0, obj_id=obj_id,
            R=np.asarray(R, np.float64), t=np.asarray(t, np.float64),
            cam_K=K, bbox_visib=bbox, bbox_obj=bbox, visib_fract=1.0,
            depth_path=depth, img_type="syn"))
    return samples
