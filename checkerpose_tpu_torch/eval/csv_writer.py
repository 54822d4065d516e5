"""BOP19 result CSV writer + merger (the port's copy of
checkerpose_tpu/eval/csv_writer.py), byte-compatible with the reference
(`tools_for_BOP/write_to_cvs.py:6-63`, `merge_csv.py:6-26`) so the official
bop_toolkit scoring scripts consume the output unchanged."""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def write_csv(out_dir: str, filename: str, obj_id: int, scene_ids, im_ids,
              Rs, ts, scores):
    """One row per estimate: scene_id,im_id,obj_id,score,R(9 space-sep),
    t(3 space-sep),time. Rows with score == -1 are skipped (failed/missing
    detections), as in the reference (`write_to_cvs.py:12-13`)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename + ".csv")
    with open(path, "w") as f:
        f.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for scene_id, im_id, R, t, score in zip(scene_ids, im_ids, Rs, ts, scores):
            if score == -1:
                continue
            R = np.asarray(R).reshape(3, 3)
            t = np.asarray(t).reshape(3)
            r_str = " ".join(str(v) for v in R.reshape(-1))
            t_str = " ".join(str(v) for v in t)
            f.write(f"{scene_id},{im_id},{obj_id},{score},{r_str},{t_str},-1\n")
    print("result saved to: ", path)
    return path


def merge_csv(csv_paths: Sequence[str], out_path: str):
    """Concatenate per-object CSVs into one submission file."""
    header_written = False
    with open(out_path, "w") as out:
        for p in csv_paths:
            with open(p) as f:
                header = f.readline()
                if not header_written:
                    out.write(header)
                    header_written = True
                for line in f:
                    out.write(line)
    return out_path
