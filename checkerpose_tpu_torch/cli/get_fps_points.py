"""Generate the FPS keypoint pkls of a BOP dataset (counterpart of
checkerpose_tpu/cli/get_fps_points.py, same flags and output files):

  python -m checkerpose_tpu_torch.cli.get_fps_points --bop_path <bop> \
      --dataset lmo [--npoint_log2 12] [--fps_version fps_202212]

One `<bop>/<dataset>/<fps_version>/obj_XXXXXX.pkl` per object of
models_info.json, in the schema of the reference's shipped files
({npoint, id, xyz}; `preprocess_data/get_fps_points.py:100-123`).
"""
from __future__ import annotations

import argparse
import os

from checkerpose_tpu_torch.data.bop_io import load_models_info, model_ply_path
from checkerpose_tpu_torch.data.fps import generate_fps_keypoints, save_fps_pkl


def main(bop_path: str, dataset: str, npoint_log2: int = 12,
         fps_version: str = "fps_202212"):
    info = load_models_info(bop_path, dataset)
    out_dir = os.path.join(bop_path, dataset, fps_version)
    for obj_id in sorted(info):
        ply = model_ply_path(bop_path, dataset, obj_id)
        if not os.path.isfile(ply):
            print(f"skip obj {obj_id}: {ply} missing")
            continue
        payload = generate_fps_keypoints(ply, npoint_log2)
        save_fps_pkl(payload, os.path.join(out_dir, f"obj_{obj_id:06d}.pkl"))
        print(f"obj {obj_id}: {payload['npoint']} FPS points -> {out_dir}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FPS keypoint pkls of a BOP dataset")
    p.add_argument("--bop_path", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--npoint_log2", type=int, default=12)
    p.add_argument("--fps_version", default="fps_202212")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(a.bop_path, a.dataset, a.npoint_log2, a.fps_version)
