"""Port solver (solver/epnp.py, solver/ransac.py) vs the JAX solver, f32 on CPU."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.ops.geometry import make_code_labels, project_pts
from checkerpose_tpu.solver.ransac import _sample_hypotheses
from checkerpose_tpu.solver.ransac import FAST_PROFILE as JAX_FAST
from checkerpose_tpu.solver.ransac import solve_poses_batched as jax_solve
from checkerpose_tpu_torch.eval.decode import ids_to_correspondences
from checkerpose_tpu_torch.solver import epnp as tepnp
from checkerpose_tpu_torch.solver.ransac import (FAST_PROFILE, sample_hypotheses,
                                                 solve_poses_batched)
from torch_parity import LM_K as K
from torch_parity import pnp_problems, random_rotation, rot_deg

# the JAX solver package re-exports the function `epnp` over its module name
jepnp = importlib.import_module("checkerpose_tpu.solver.epnp")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("use_eigh,noise", [(True, 0.0), (False, 0.5)])
def test_epnp_matches_jax(use_eigh, noise):
    """With use_eigh the control points come from eigenvectors whose signs
    LAPACK picks freely, and EPnP on noisy points is not invariant to that
    basis: both sides are then held on exact correspondences. The
    hypothesis path (fixed basis) is held on noisy ones."""
    p3d, p2d, valid, w, Rs, ts = pnp_problems(6, 40, seed=1, noise=noise)
    Kb = np.broadcast_to(K, (6, 3, 3))
    jR, jt = jax.jit(jax.vmap(lambda a, b, k, ww: jepnp.epnp(a, b, k, ww, use_eigh=use_eigh)))(
        p3d, p2d, Kb, w)
    tR, tt = tepnp.epnp(_t(p3d), _t(p2d), _t(np.ascontiguousarray(Kb)), _t(w), use_eigh=use_eigh)
    # two f32 implementations of the same closed form, summed in another
    # order: rotations within 0.05 deg, translations within 0.05 units
    # (~1e-4 relative at depth 400)
    assert rot_deg(tR.numpy(), np.asarray(jR)).max() < 0.05
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=5e-2)
    assert rot_deg(tR.numpy(), Rs).max() < 3.0          # and near the truth


def test_refine_and_reproj_match_jax():
    p3d, p2d, valid, w, Rs, ts = pnp_problems(6, 40, seed=2)
    Kb = np.ascontiguousarray(np.broadcast_to(K, (6, 3, 3)))
    rng = np.random.default_rng(3)
    # start ~3 deg and a few units off the truth
    R0 = np.stack([np.asarray(jepnp.rodrigues(jnp.asarray(rng.normal(0, 0.03, 3)))) for _ in range(6)])
    R0 = (R0 @ Rs).astype(np.float32)
    t0 = (ts + rng.normal(0, 3, ts.shape)).astype(np.float32)

    jerr = jax.jit(jax.vmap(jepnp.reproj_errors))(R0, t0, p3d, p2d, Kb)
    terr = tepnp.reproj_errors(_t(R0), _t(t0), _t(p3d), _t(p2d), _t(Kb))
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-4, atol=1e-3)

    jR, jt = jax.jit(jax.vmap(lambda *a: jepnp.refine_pose_gn(*a, iters=5, n_backtrack=2)))(
        R0, t0, p3d, p2d, Kb, w)
    tR, tt = tepnp.refine_pose_gn(_t(R0), _t(t0), _t(p3d), _t(p2d), _t(Kb), _t(w),
                                  iters=5, n_backtrack=2)
    assert rot_deg(tR.numpy(), np.asarray(jR)).max() < 0.05
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=5e-2)
    # project_so3 returns an orthonormal matrix
    np.testing.assert_allclose(tR.numpy() @ np.swapaxes(tR.numpy(), 1, 2),
                               np.broadcast_to(np.eye(3), (6, 3, 3)), atol=1e-5)


@pytest.mark.parametrize("mode", [
    dict(FAST_PROFILE),
    dict(num_hyp=32, soft_inlier_sigma=0.5, coherence_weight=0.1, refine_iters=4,
         reseed=True, n_backtrack=2),
], ids=["fast_hard", "soft_coherence_reseed"])
def test_solve_poses_batched_on_jax_hypotheses(mode):
    """The port's RANSAC on the JAX sampler's own indices (rebuilt as
    ransac.py does: split the key per image, then _sample_hypotheses)."""
    B, N = 4, 64
    p3d, p2d, valid, _, Rs, ts = pnp_problems(B, N, seed=4, noise=0.7, outliers=0.2)
    key = jax.random.PRNGKey(7)
    jsol = jax_solve(p3d, p2d, valid, K, key, **mode)
    keys = jax.random.split(key, B)
    hyp = np.stack([np.asarray(_sample_hypotheses(keys[b], jnp.asarray(valid[b]),
                                                  mode["num_hyp"], 6)) for b in range(B)])
    tsol = solve_poses_batched(p3d, p2d, valid, K, hyp_idx=hyp, device="cpu", **mode)
    # same hypotheses and the same f32 math: poses agree to 0.05 deg and 0.1
    assert rot_deg(tsol["R"].numpy(), np.asarray(jsol["R"])).max() < 0.05
    np.testing.assert_allclose(tsol["t"].numpy(), np.asarray(jsol["t"]), atol=0.1)
    np.testing.assert_array_equal(tsol["success"].numpy(), np.asarray(jsol["success"]))
    assert np.abs(tsol["num_inliers"].numpy() - np.asarray(jsol["num_inliers"])).max() <= 2


def test_sampler_draws_valid_indices():
    valid = torch.zeros(3, 50)
    valid[:, ::3] = 1.0
    g = torch.Generator().manual_seed(0)
    idx = sample_hypotheses(valid, 16, 6, g)
    assert idx.shape == (3, 16, 6)
    assert bool((idx % 3 == 0).all())
    assert all(len(set(row.tolist())) == 6 for row in idx.reshape(-1, 6))


def test_oracle_codes_recover_pose():
    """Exact codes of known poses -> port decode -> port solver (the
    construction of tests/test_serving.py::test_oracle_codes_recover_pose)."""
    rng = np.random.default_rng(0)
    N, B, S = 256, 4, 64
    p3d = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
    Rs, ts, rois, xs, ys, bboxes = [], [], [], [], [], []
    for i in range(B):
        R = np.asarray(random_rotation(np.random.default_rng(i)))
        t = np.array([rng.uniform(-20, 20), rng.uniform(-20, 20), rng.uniform(350, 500)])
        uv, _ = project_pts(p3d.astype(np.float64), K.astype(np.float64), R, t)
        side = max(np.ptp(uv[:, 0]), np.ptp(uv[:, 1])) * 1.4
        bbox = np.array([uv[:, 0].min() - side * 0.15, uv[:, 1].min() - side * 0.15,
                         side, side], np.float32)
        roi, x, y = make_code_labels(jnp.asarray(uv, jnp.float32), jnp.asarray(bbox), S)
        Rs.append(R); ts.append(t); rois.append(roi); xs.append(x); ys.append(y)
        bboxes.append(bbox)
    with torch.inference_mode():
        p2d, valid = ids_to_correspondences(
            _t(np.stack(xs)), _t(np.stack(ys)), _t(np.stack(rois)), _t(np.stack(bboxes)),
            crop_size_gt=S)
    sol = solve_poses_batched(p3d, p2d, valid, K, torch.Generator().manual_seed(0),
                              device="cpu", num_hyp=64)
    for i in range(B):
        assert rot_deg(sol["R"][i].double().numpy(), Rs[i]) < 3.0
        assert np.linalg.norm(sol["t"][i].double().numpy() - ts[i]) < 10.0
        assert bool(sol["success"][i])


def test_degenerate_batch_fails_cleanly():
    """Fewer than 4 valid points or collapsed correspondences: identity
    pose, success False, nothing raised, like the JAX solver."""
    p3d, p2d, valid, _, _, _ = pnp_problems(3, 20, seed=5)
    valid[0] = 0.0
    valid[0, :3] = 1.0
    p2d[1] = p2d[1, :1]                         # every point on one pixel
    sol = solve_poses_batched(p3d, p2d, valid, K, torch.Generator().manual_seed(0),
                              device="cpu", **FAST_PROFILE)
    jsol = jax_solve(p3d, p2d, valid, K, jax.random.PRNGKey(0), **JAX_FAST)
    assert not bool(sol["success"][0])
    np.testing.assert_array_equal(sol["R"][0].numpy(), np.eye(3, dtype=np.float32))
    assert bool(torch.isfinite(sol["R"]).all()) and bool(torch.isfinite(sol["t"]).all())
    assert bool(sol["success"][2]) and bool(np.asarray(jsol["success"])[2])
