"""Port eval/metrics.py against the JAX package's and against float64 numpy
brute force: ADD, ADI, re, te, the batched errors with and without discrete
symmetries, symmetry transforms, AUC, mask metrics and pass rates. f32 on the
CPU; tolerance 1e-4 mm + 1e-5 relative for distances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.eval import metrics as J
from checkerpose_tpu_torch.eval import metrics as M

ATOL_MM, RTOL = 1e-4, 1e-5


def _rot(rng, n):
    Q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    return Q


def _poses(seed, B=6, V=300, near=False):
    """f32 model points (mm), GT poses and estimates (near the GT or random)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (V, 3)).astype(np.float32)
    R_gt = _rot(rng, B)
    t_gt = np.stack([rng.uniform(-50, 50, B), rng.uniform(-50, 50, B),
                     rng.uniform(350, 550, B)], -1)
    if near:
        small = _rot(rng, B) * 0.02 + np.eye(3) * 0.98
        R_est = np.stack([np.linalg.qr(r)[0] * np.sign(np.diag(np.linalg.qr(r)[1]))
                          for r in small @ R_gt])
        t_est = t_gt + rng.normal(0, 2.0, (B, 3))
    else:
        R_est, t_est = _rot(rng, B), t_gt + rng.normal(0, 30.0, (B, 3))
    return [a.astype(np.float32) for a in (R_est, t_est, R_gt, t_gt)] + [pts]


def _f64_add(Re, te, Rg, tg, pts):
    p = pts.astype(np.float64)
    return np.linalg.norm(p @ Re.T.astype(np.float64) + te - (p @ Rg.T + tg), axis=-1).mean()


def _f64_adi(Re, te, Rg, tg, pts):
    p = pts.astype(np.float64)
    pe, pg = p @ Re.T.astype(np.float64) + te, p @ Rg.T.astype(np.float64) + tg
    return np.sqrt(((pg[:, None] - pe[None]) ** 2).sum(-1)).min(1).mean()


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("near", [False, True])
@pytest.mark.parametrize("use_adi", [False, True])
def test_batched_pose_errors_match_jax_and_f64(use_adi, near):
    Re, te, Rg, tg, pts = _poses(1 + near, near=near)
    got = {k: v.numpy() for k, v in M.batched_pose_errors(*_t(Re, te, Rg, tg, pts),
                                                          use_adi=use_adi).items()}
    ref = {k: np.asarray(v) for k, v in J.batched_pose_errors(
        *(jnp.asarray(a) for a in (Re, te, Rg, tg, pts)), use_adi=use_adi).items()}
    f64 = _f64_adi if use_adi else _f64_add
    exact = np.array([f64(*a, pts) for a in zip(Re, te.astype(np.float64), Rg,
                                                tg.astype(np.float64))])
    np.testing.assert_allclose(got["adx"], exact, rtol=RTOL, atol=ATOL_MM)
    np.testing.assert_allclose(got["adx"], ref["adx"], rtol=RTOL, atol=ATOL_MM)
    np.testing.assert_allclose(got["te"], np.linalg.norm(te.astype(np.float64) - tg, axis=1),
                               rtol=RTOL, atol=ATOL_MM)
    np.testing.assert_allclose(got["te"], ref["te"], rtol=RTOL, atol=ATOL_MM)
    cos = (np.einsum("bij,bij->b", Re.astype(np.float64), Rg) - 1) / 2
    # arccos near cos = 1 in f32: one ulp of cos is 0.02 deg of angle
    np.testing.assert_allclose(got["re"], np.degrees(np.arccos(np.clip(cos, -1, 1))), atol=0.05)
    np.testing.assert_allclose(got["re"], ref["re"], atol=0.05)


def test_gt_poses_give_zero_and_adi_chunks():
    Re, te, Rg, tg, pts = _poses(3, B=4, V=700)
    out = M.batched_pose_errors(*_t(Rg, tg, Rg, tg, pts), use_adi=False)
    assert float(out["adx"].abs().max()) == 0.0 and float(out["te"].abs().max()) == 0.0
    assert float(out["re"].max()) < 0.05
    # blocks of a few rows and poses at a time give the same as one block
    full = M.adi_error(*_t(Re, te, Rg, tg, pts))
    old = M._ADI_BLOCK
    try:
        M._ADI_BLOCK = 900
        np.testing.assert_allclose(M.adi_error(*_t(Re, te, Rg, tg, pts)).numpy(), full.numpy(),
                                   rtol=1e-6)
    finally:
        M._ADI_BLOCK = old
    one = M.adi_error(*_t(Re[0], te[0], Rg[0], tg[0], pts))
    assert one.shape == () and abs(float(one) - float(full[0])) < 1e-4
    assert float(M.adi_error(*_t(Rg, tg, Rg, tg, pts)).max()) == 0.0


def test_unbatched_errors_match_jax():
    Re, te, Rg, tg, pts = _poses(4, B=1)
    args = (Re[0], te[0], Rg[0], tg[0], pts)
    np.testing.assert_allclose(float(M.add_error(*_t(*args))),
                               float(J.add_error(*(jnp.asarray(a) for a in args))),
                               rtol=RTOL, atol=ATOL_MM)
    np.testing.assert_allclose(float(M.re_error(*_t(Re[0], Rg[0]))),
                               float(J.re_error(jnp.asarray(Re[0]), jnp.asarray(Rg[0]))),
                               atol=0.05)
    np.testing.assert_allclose(float(M.te_error(*_t(te[0], tg[0]))),
                               float(J.te_error(jnp.asarray(te[0]), jnp.asarray(tg[0]))),
                               rtol=RTOL)


def test_symmetries():
    info = {"diameter": 100.0,
            "symmetries_discrete": [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 3.0, 0, 0, 0, 1]],
            "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]}
    a, b = M.symmetry_transformations(info, 0.5), J.symmetry_transformations(info, 0.5)
    assert len(a) == len(b) == 2 + 7
    for (ra, ta), (rb, tb) in zip(a, b):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ta, tb)
    sym = np.stack([r for r, _ in a[:2]]).astype(np.float32)     # identity + 180 deg about z
    Re, te, Rg, tg, pts = _poses(5, B=5)
    R_est = (Rg @ sym[1]).astype(np.float32)                    # a symmetric pose of the GT
    got = M.batched_pose_errors(*_t(R_est, tg, Rg, tg, pts), sym_rots=sym)
    ref = J.batched_pose_errors(*(jnp.asarray(x) for x in (R_est, tg, Rg, tg, pts)),
                                sym_rots=jnp.asarray(sym))
    assert float(got["re"].max()) < 0.05
    np.testing.assert_allclose(got["re"].numpy(), np.asarray(ref["re"]), atol=0.05)
    plain = M.batched_pose_errors(*_t(R_est, tg, Rg, tg, pts))
    assert float(plain["re"].min()) > 179.0
    for i in range(2):
        np.testing.assert_allclose(
            float(M.closest_symmetric_rot_error(Re[i], Rg[i], sym)),
            float(J.closest_symmetric_rot_error(Re[i], Rg[i], sym)), atol=0.05)


def test_auc_mask_metrics_pass_rates():
    rng = np.random.default_rng(6)
    errs = np.concatenate([rng.uniform(0, 0.15, 40), [np.inf]])
    assert M.compute_auc_posecnn(errs) == J.compute_auc_posecnn(errs)
    assert np.isnan(M.compute_auc_posecnn(np.full(3, np.inf)))
    pred = rng.random((5, 16, 16)) > 0.5
    gt = (rng.random((5, 16, 16)) > 0.6).astype(np.float32)
    gt[4] = 0.0
    pred[4] = False                                              # empty union: IoU 1
    err, iou = M.batched_mask_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    for b in range(5):
        want = J.mask_metrics(pred[b], gt[b])
        assert M.mask_metrics(pred[b], gt[b]) == want
        np.testing.assert_allclose([float(err[b]), float(iou[b])], want, rtol=1e-6)
    assert float(iou[4]) == 1.0
    re = rng.uniform(0, 8, 50)
    te = rng.uniform(0, 70, 50)
    te[3] = np.inf
    assert M.rete_pass_rates(re, te) == J.rete_pass_rates(re, te)
