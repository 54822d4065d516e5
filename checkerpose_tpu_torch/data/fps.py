"""FPS keypoint generation + loading (the port's copy of
checkerpose_tpu/data/fps.py).

The reference ships per-object FPS keypoint pkls
(`datasets/BOP_DATASETS/<ds>/fps_202212/obj_XXXXXX.pkl`, dict
{npoint, id, xyz}) generated by `preprocess_data/get_fps_points.py`. We read
that exact format and can regenerate it from a mesh with the same
bbox-center-seeded FPS (ops.geometry.farthest_point_sample).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from checkerpose_tpu_torch.data.ply import load_ply_vertices
from checkerpose_tpu_torch.ops.geometry import farthest_point_sample, pc_normalize


def generate_fps_keypoints(ply_path: str, npoint_log2: int = 12) -> dict:
    """FPS-sample 2**npoint_log2 keypoints from mesh vertices; same payload
    schema as the reference pkls (`get_fps_points.py:100-123`)."""
    verts = load_ply_vertices(ply_path)
    n = 2 ** npoint_log2
    idx = farthest_point_sample(verts, n, init_center=True)
    return {"npoint": n, "id": idx, "xyz": verts[idx]}


def save_fps_pkl(payload: dict, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_fps_points(bop_dir: str, dataset: str, obj_id: int, num_p3d: int,
                    fps_version: str = "fps_202212") -> np.ndarray:
    """First `num_p3d` FPS keypoints (FPS order is a prefix property: the
    first k of an n-point FPS sample are themselves well-spread). The
    reference slices identically (`train.py:115-118`). Returns (num_p3d, 3)
    float32, unit mm."""
    path = os.path.join(bop_dir, dataset, fps_version, f"obj_{obj_id:06d}.pkl")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    xyz = np.asarray(payload["xyz"], np.float32)
    if xyz.shape[0] < num_p3d:
        raise ValueError(f"{path} holds {xyz.shape[0]} points < requested {num_p3d}")
    return xyz[:num_p3d]


def load_keypoints_normed(bop_dir: str, dataset: str, obj_id: int, num_p3d: int,
                          fps_version: str = "fps_202212"):
    """(unnorm (N,3) mm, normed (N,3) in unit ball) -- the pair every entry
    point needs (reference `train.py:115-121`)."""
    xyz = load_fps_points(bop_dir, dataset, obj_id, num_p3d, fps_version)
    return xyz, pc_normalize(xyz.astype(np.float64)).astype(np.float32)
