"""Synthetic BOP dataset fixture (counterpart of
checkerpose_tpu/data/synthetic.py, same signature, layout and random stream).

Generates a small but complete BOP-layout dataset on disk (scenes, masks, GT
jsons, models + models_info, FPS keypoints, detection results) so that the
test entry point and the eval harness run end to end without the real BOP
data. Objects are noisy convex blobs; an image is the filled projected hull
on a textured background, with the vertices splatted far to near in colours
that follow their object-frame coordinates.

Drawing is numpy and scipy only: the hull is filled by half-plane tests
that take in the pixels OpenCV's outline would (within half a pixel of an
edge), and each vertex is a filled disc with the rows of OpenCV's midpoint
circle. The frames and masks go into the frame cache (`data/framestore.py`),
and into PNG files only where an image codec imports; with none, the cache
is written whatever `raw_cache` says. The `test` split's scene depth maps
(what VSD scoring reads) are rendered from the mesh (`eval/renderer.py`) and
always written as 16-bit PNGs in mm by the package's own encoder
(`data/imageio.py::write_depth_png`), codec or none; rendering draws
nothing from the random stream.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np
from scipy.spatial import ConvexHull

from checkerpose_tpu_torch.data.framestore import FrameCacheWriter
from checkerpose_tpu_torch.data import imageio
from checkerpose_tpu_torch.data.ply import save_ply_vertices
from checkerpose_tpu_torch.eval.renderer import render_depth
from checkerpose_tpu_torch.ops.geometry import farthest_point_sample

K_DEFAULT = np.array([[572.4114, 0.0, 325.2611],
                      [0.0, 573.57043, 242.04899],
                      [0.0, 0.0, 1.0]])
IM_W, IM_H = 640, 480


def _make_object(rng, radius=40.0, n=64, lumpiness=0.25):
    """Noisy convex blob: points on a sphere with a smooth radial field and
    per-vertex jitter."""
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    basis = rng.standard_normal((3, 3))
    field = np.tanh(v @ basis).sum(axis=1) / 3.0
    r = radius * (1.0 + lumpiness * field + 0.15 * rng.random(n))
    return v * r[:, None]


def _random_rotation(rng):
    A = rng.standard_normal((3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _vertex_colors(n, rng, verts=None):
    """Per-vertex colours: a ramp over the object-frame coordinates (so the
    pose is readable from which colours are where) plus a small gray jitter."""
    if verts is None:
        gray = rng.integers(30, 256, (n, 1))
        return np.repeat(gray, 3, axis=1).astype(np.int64)
    lo, hi = verts.min(0), verts.max(0)
    ramp = 40.0 + 175.0 * (verts - lo) / (hi - lo + 1e-9)
    jitter = rng.integers(-15, 16, (n, 1))
    return np.clip(ramp.astype(np.int64) + jitter, 0, 255)


def _fill_convex_hull(mask, uv):
    """Set to 255 the pixels of the convex hull of integer points uv (M, 2),
    its outline included."""
    hull = uv[ConvexHull(uv).vertices].astype(np.float64)       # counter-clockwise
    x0, y0 = np.maximum(hull.min(0).astype(int), 0)
    x1 = min(int(hull[:, 0].max()), mask.shape[1] - 1)
    y1 = min(int(hull[:, 1].max()), mask.shape[0] - 1)
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    inside = np.ones(xs.shape, bool)
    for a, b in zip(hull, np.roll(hull, -1, axis=0)):
        e = b - a
        cross = e[0] * (ys - a[1]) - e[1] * (xs - a[0])
        # a pixel within half a pixel of the edge along its minor axis lies
        # on the outline an 8-connected line draws
        inside &= cross >= -0.5 * np.abs(e).max()
    mask[y0:y1 + 1, x0:x1 + 1][inside] = 255


def _disc_offsets(radius: int):
    """(dy, dx) offsets of a filled disc: the rows of the midpoint circle."""
    half = np.zeros(radius + 1, np.int64)
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        half[dy] = max(half[dy], dx)
        half[dx] = max(half[dx], dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return np.array([(oy, ox) for oy in range(-radius, radius + 1)
                     for ox in range(-half[abs(oy)], half[abs(oy)] + 1)])


def _splat(obj, uv, order, radius, colors):
    """Draw a disc per vertex in `order`, later ones over earlier ones."""
    offs = _disc_offsets(radius)
    px = uv[order, 0][:, None] + offs[None, :, 1]                 # (V, D)
    py = uv[order, 1][:, None] + offs[None, :, 0]
    keep = (px >= 0) & (px < obj.shape[1]) & (py >= 0) & (py < obj.shape[0])
    flat = (py * obj.shape[1] + px)[keep]
    rank = np.broadcast_to(np.arange(len(order))[:, None], px.shape)[keep]
    # the last writer of each pixel wins: first occurrence in reverse order
    rev = np.argsort(-rank, kind="stable")
    pix, first = np.unique(flat[rev], return_index=True)
    obj.reshape(-1, 3)[pix] = colors[order][rank[rev][first]]


def _render(verts, R, t, K, rng, vert_colors):
    cam = verts @ R.T + t[None]
    uvf = cam @ K.T
    uv = (uvf[:, :2] / uvf[:, 2:3]).astype(np.int32)
    depth = cam[:, 2]
    img = (rng.integers(40, 200, (IM_H, IM_W, 3))).astype(np.uint8)
    img[:, ::7] = img[:, ::7] // 2
    mask = np.zeros((IM_H, IM_W), np.uint8)
    _fill_convex_hull(mask, uv)
    obj = np.full((IM_H, IM_W, 3), 90, np.uint8)
    order = np.argsort(-depth)
    rad = max(int(12 * 400.0 / float(depth.mean()) * (64.0 / len(verts)) ** 0.5), 2)
    _splat(obj, uv, order, rad, vert_colors.astype(np.uint8))
    fg = mask > 0
    img[fg] = obj[fg]
    return img, mask


def make_synthetic_bop(root: str, dataset: str = "synth", n_objects: int = 2,
                       n_scenes: int = 2, n_images: int = 8, seed: int = 0,
                       folders=("train_real", "train_pbr", "test"),
                       n_vertices: int = 64, raw_cache: bool = False,
                       write_png: bool = True, progress: bool = False):
    """Write a complete miniature BOP dataset under `<root>/<dataset>` and
    return its directory.

      * `folders` may be a dict {folder: n_images per scene}.
      * `n_vertices`: mesh density; >= 512 gives 512 FPS keypoints.
      * `raw_cache=True`: also write the frame cache under
        `<ds_dir>/frame_cache`; written anyway when no PNG can be.
      * `write_png=False`: no PNG files (GT jsons and detections are still
        written, so manifests scan fine).
    """
    if write_png and not imageio.have_codec():
        print("make_synthetic_bop: no image codec importable (cv2 or PIL); writing the "
              "frame cache instead of PNG files", flush=True)
        write_png, raw_cache = False, True
    rng = np.random.default_rng(seed)
    ds_dir = os.path.join(root, dataset)
    models_dir = os.path.join(ds_dir, "models")
    os.makedirs(models_dir, exist_ok=True)
    if not isinstance(folders, dict):
        folders = {f: n_images for f in folders}
    writer = None
    if raw_cache:
        total = sum(folders.values()) * n_scenes
        writer = FrameCacheWriter(os.path.join(ds_dir, "frame_cache"),
                                  (IM_H, IM_W), total, total)

    models_info, objects, faces = {}, {}, {}
    fps_dir = os.path.join(ds_dir, "fps_202212")
    os.makedirs(fps_dir, exist_ok=True)
    for obj_id in range(1, n_objects + 1):
        verts = _make_object(rng, n=n_vertices)
        objects[obj_id] = verts
        faces[obj_id] = ConvexHull(verts).simplices.astype(np.int32)
        save_ply_vertices(os.path.join(models_dir, f"obj_{obj_id:06d}.ply"),
                          verts, faces[obj_id])
        d = np.linalg.norm(verts[:, None] - verts[None], axis=-1).max()
        models_info[str(obj_id)] = {
            "diameter": float(d),
            "min_x": float(verts[:, 0].min()), "max_x": float(verts[:, 0].max()),
            "min_y": float(verts[:, 1].min()), "max_y": float(verts[:, 1].max()),
            "min_z": float(verts[:, 2].min()), "max_z": float(verts[:, 2].max()),
        }
        npt = min(512, len(verts))
        idx = farthest_point_sample(verts, npt)
        with open(os.path.join(fps_dir, f"obj_{obj_id:06d}.pkl"), "wb") as f:
            pickle.dump({"npoint": npt, "id": idx, "xyz": verts[idx]}, f)
    with open(os.path.join(models_dir, "models_info.json"), "w") as f:
        json.dump(models_info, f)
    eval_dir = os.path.join(ds_dir, "models_eval")          # the same models
    os.makedirs(eval_dir, exist_ok=True)
    for obj_id in range(1, n_objects + 1):
        save_ply_vertices(os.path.join(eval_dir, f"obj_{obj_id:06d}.ply"),
                          objects[obj_id], faces[obj_id])
    with open(os.path.join(eval_dir, "models_info.json"), "w") as f:
        json.dump(models_info, f)
    with open(os.path.join(ds_dir, "camera.json"), "w") as f:
        json.dump({"cx": K_DEFAULT[0, 2], "cy": K_DEFAULT[1, 2],
                   "fx": K_DEFAULT[0, 0], "fy": K_DEFAULT[1, 1],
                   "width": IM_W, "height": IM_H, "depth_scale": 1.0}, f)

    vert_colors = {obj_id: _vertex_colors(len(objects[obj_id]), rng, verts=objects[obj_id])
                   for obj_id in objects}
    detections, targets = {}, []
    for folder, n_im in folders.items():
        for scene_id in range(n_scenes):
            scene_dir = os.path.join(ds_dir, folder, f"{scene_id:06d}")
            for sub in ("rgb", "mask", "mask_visib"):
                os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
            scene_camera, scene_gt, scene_gt_info = {}, {}, {}
            for im_id in range(n_im):
                obj_id = (im_id % n_objects) + 1
                verts = objects[obj_id]
                R = _random_rotation(rng)
                t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                              rng.uniform(350, 550)])
                img, mask = _render(verts, R, t, K_DEFAULT, rng, vert_colors[obj_id])
                ys, xs = np.nonzero(mask)
                bbox = [int(xs.min()), int(ys.min()),
                        int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]
                rgb_p = os.path.join(scene_dir, "rgb", f"{im_id:06d}.png")
                mask_p = os.path.join(scene_dir, "mask", f"{im_id:06d}_000000.png")
                maskv_p = os.path.join(scene_dir, "mask_visib", f"{im_id:06d}_000000.png")
                # `img` is in the channel order the JAX package hands to
                # cv2.imwrite (BGR), so the file and the cache hold img[..., ::-1]
                rgb = img[:, :, ::-1]
                if write_png:
                    imageio.write_png(rgb_p, rgb)
                    imageio.write_png(mask_p, mask)
                    imageio.write_png(maskv_p, mask)
                if writer is not None:
                    writer.add_frame(rgb_p, rgb)
                    writer.add_mask(mask_p, mask)
                    writer.alias_mask(maskv_p, mask_p)
                if progress and (im_id + 1) % 500 == 0:
                    print(f"  {folder}/{scene_id}: {im_id + 1}/{n_im}", flush=True)
                scene_camera[str(im_id)] = {"cam_K": K_DEFAULT.reshape(-1).tolist(),
                                            "depth_scale": 1.0}
                scene_gt[str(im_id)] = [{
                    "obj_id": obj_id,
                    "cam_R_m2c": R.reshape(-1).tolist(),
                    "cam_t_m2c": t.tolist(),
                }]
                scene_gt_info[str(im_id)] = [{
                    "bbox_obj": bbox, "bbox_visib": bbox,
                    "px_count_all": int(mask.sum() // 255),
                    "px_count_visib": int(mask.sum() // 255),
                    "visib_fract": 1.0,
                }]
                if folder == "test":
                    os.makedirs(os.path.join(scene_dir, "depth"), exist_ok=True)
                    dep = render_depth(verts, faces[obj_id], R, t, K_DEFAULT, IM_W, IM_H)
                    imageio.write_depth_png(os.path.join(scene_dir, "depth", f"{im_id:06d}.png"),
                                            np.clip(dep, 0, 65535).astype(np.uint16))
                    # jittered detector boxes, one slightly-worse duplicate
                    jit = rng.integers(-6, 7, 4)
                    det_bbox = [int(bbox[0] + jit[0]), int(bbox[1] + jit[1]),
                                int(bbox[2] + jit[2]), int(bbox[3] + jit[3])]
                    detections[f"{scene_id}/{im_id}"] = [
                        {"obj_id": obj_id, "bbox_est": det_bbox, "score": 0.9,
                         "time": 0.05},
                        {"obj_id": obj_id, "bbox_est": bbox, "score": 0.5,
                         "time": 0.05},
                    ]
                    targets.append({"im_id": im_id, "inst_count": 1,
                                    "obj_id": obj_id, "scene_id": scene_id})
            for name, payload in (("scene_camera.json", scene_camera),
                                  ("scene_gt.json", scene_gt),
                                  ("scene_gt_info.json", scene_gt_info)):
                with open(os.path.join(scene_dir, name), "w") as f:
                    json.dump(payload, f)

    if writer is not None:
        writer.finalize()
    det_dir = os.path.join(root, "detection_results", dataset)
    os.makedirs(det_dir, exist_ok=True)
    with open(os.path.join(det_dir, "synth_detections.json"), "w") as f:
        json.dump(detections, f)
    with open(os.path.join(ds_dir, "test_targets_bop19.json"), "w") as f:
        json.dump(targets, f)
    return ds_dir

