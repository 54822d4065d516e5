"""Self-occlusion of keypoints: overall visibility by Hidden Point Removal
(the port's copy of checkerpose_tpu/data/visibility.py, numpy and scipy).

The reference's offline tool (`preprocess_data/get_overall_visibility.py:
20-113`): for each sampled view, Katz et al.'s HPR operator (spherical flip
+ convex hull) on the camera-frame keypoints, then visibility averaged over
the views. The reference ships 2562 view rotations (`datasets/
sampled_poses_2562.pkl`); `sample_view_rotations` makes an equivalent
uniform set from a Fibonacci sphere, so no data file is needed.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull


def compute_vis_hpr(points_cam: np.ndarray, gamma_exp: float = 1.0) -> np.ndarray:
    """Visible-point mask for a camera at the origin: the points flipped
    about a sphere of radius R around the camera are visible where they lie
    on the convex hull of the flipped cloud plus the origin
    (`get_overall_visibility.py:20-42`)."""
    n = points_cam.shape[0]
    norms = np.linalg.norm(points_cam, axis=1, keepdims=True)
    R = norms.max() * (10.0 ** gamma_exp)
    flipped = points_cam + 2 * (R - norms) * (points_cam / np.maximum(norms, 1e-12))
    cloud = np.vstack([flipped, np.zeros((1, 3))])
    hull = ConvexHull(cloud)
    visible = np.zeros(n, bool)
    idx = hull.vertices
    visible[idx[idx < n]] = True
    return visible


def sample_view_rotations(n_views: int = 2562, seed: int = 0) -> np.ndarray:
    """(n, 3, 3) rotations whose view directions cover the sphere uniformly
    (Fibonacci lattice), each with a random in-plane roll."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_views) + 0.5
    phi = np.arccos(1 - 2 * i / n_views)
    theta = np.pi * (1 + 5 ** 0.5) * i
    z_axis = np.stack([np.sin(phi) * np.cos(theta),
                       np.sin(phi) * np.sin(theta),
                       np.cos(phi)], axis=1)
    rolls = rng.uniform(0, 2 * np.pi, n_views)
    Rs = np.zeros((n_views, 3, 3))
    for k in range(n_views):
        z = z_axis[k]
        up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.99 else np.array([1.0, 0.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c, s = np.cos(rolls[k]), np.sin(rolls[k])
        Rs[k] = np.stack([c * x + s * y, -s * x + c * y, z], axis=0)
    return Rs


def overall_visibility(points: np.ndarray, rotations: np.ndarray | None = None,
                       t_z: float = 400.0, gamma_exp: float = 1.0) -> np.ndarray:
    """Per-point visibility ratio averaged over views, the object at
    t = (0, 0, t_z) for every rotation (`get_overall_visibility.py:99-113`)."""
    if rotations is None:
        rotations = sample_view_rotations(2562)
    t = np.array([0.0, 0.0, t_z])
    acc = np.zeros(points.shape[0])
    for R in rotations:
        acc += compute_vis_hpr(points @ R.T + t, gamma_exp)
    return acc / len(rotations)
