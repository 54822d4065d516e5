"""Rewrite an LMO config into a YCBV config (counterpart of
checkerpose_tpu/cli/convert_cfg_lmo_to_ycbv.py, same flags):

  python -m checkerpose_tpu_torch.cli.convert_cfg_lmo_to_ycbv --cfg config/lmo/x.txt \
      --out config/ycbv/x.txt [--detection_results <json>]

The reference tool's three edits (`convert_cfg_lmo_to_ycbv.py:24-33`):
dataset_name, second_dataset_ratio (0.875 for ycbv) and the detection file;
every other line is copied as it is.
"""
from __future__ import annotations

import argparse
import os

YCBV_DETECTIONS = ("detection_results/ycbv/"
                   "fcos_V57eSE_MSx1333_ColorAugAAEWeaker_8e_ycbv_real_pbr_8e.json")


def convert(cfg_path: str, out_path: str, detection_results: str = YCBV_DETECTIONS):
    lines = []
    with open(cfg_path) as f:
        for line in f:
            key = line.split("=")[0].strip() if "=" in line else ""
            if key == "dataset_name":
                line = "dataset_name = ycbv\n"
            elif key == "second_dataset_ratio":
                line = "second_dataset_ratio = 0.875\n"
            elif key == "Detection_reaults":
                line = f"Detection_reaults = {detection_results}\n"
            lines.append(line)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.writelines(lines)
    print(f"wrote {out_path}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rewrite an LMO config for YCBV")
    p.add_argument("--cfg", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--detection_results", default=YCBV_DETECTIONS)
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    convert(a.cfg, a.out, a.detection_results)
