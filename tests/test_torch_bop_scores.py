"""The port's BOP19 scoring (`checkerpose_tpu_torch/eval/bop_scores.py`) and
depth renderer (`eval/renderer.py`) against the JAX package's, on the CPU.

MSSD and MSPD run in f32 on both sides with the products in another order
(the port writes them as multiply-adds and takes MSSD's difference of the
two posed clouds before its norm), so they agree to 1e-5 relative; the host
parts (recall, matching, symmetries, CSV, depth to distance, rendering, VSD)
are the same numpy arithmetic and agree exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from checkerpose_tpu.eval import bop_scores as J
from checkerpose_tpu.eval import renderer as jrenderer
from checkerpose_tpu_torch.eval import bop_scores as P
from checkerpose_tpu_torch.eval import renderer as prenderer

K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])

SYMMETRIES = {
    "none": {},
    "discrete": {"symmetries_discrete": [
        np.diag([-1.0, -1.0, 1.0, 1.0]).reshape(-1).tolist(),
        [0, -1, 0, 0, 1, 0, 0, 3.5, 0, 0, 1, 0, 0, 0, 0, 1]]},
    # 315 sampled rotations about an offset axis, capped to 64
    "continuous": {"symmetries_continuous": [{"axis": [0.2, 0.1, 1.0],
                                              "offset": [1.0, -2.0, 0.5]}]},
}


def _rotations(rng, n):
    Q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    return Q


def _pairs(seed, n=9, n_pts=300):
    """Random estimate / GT pose pairs in front of K (some estimates close
    to their GT, some anywhere), per-pair intrinsics and model points, f32."""
    rng = np.random.default_rng(seed)
    R_gt = _rotations(rng, n)
    R_est = np.where(np.arange(n)[:, None, None] % 2 == 0, _rotations(rng, n),
                     _rotations(rng, n) * 0.02 + R_gt)
    R_est = np.stack([np.linalg.qr(r)[0] * np.sign(np.diag(np.linalg.qr(r)[1]))
                      for r in R_est])
    t_gt = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                     rng.uniform(350, 650, n)], -1)
    t_est = t_gt + rng.normal(0, 20.0, (n, 3))
    Ks = np.tile(K, (n, 1, 1)) * rng.uniform(0.9, 1.1, (n, 1, 1))
    Ks[:, 2] = [0, 0, 1]
    pts = rng.uniform(-50, 50, (n_pts, 3))
    return [a.astype(np.float32) for a in (R_est, t_est, R_gt, t_gt, Ks, pts)]


@pytest.mark.parametrize("kind", sorted(SYMMETRIES))
def test_sym_arrays_exact(kind):
    jR, jt = J.sym_arrays(SYMMETRIES[kind])
    pR, pt = P.sym_arrays(SYMMETRIES[kind])
    assert pR.dtype == jR.dtype == np.float32 and len(pR) <= 64
    np.testing.assert_array_equal(pR, jR)
    np.testing.assert_array_equal(pt, jt)


@pytest.mark.parametrize("kind", sorted(SYMMETRIES))
def test_mssd_mspd_match_jax(kind):
    """batched_bop_errors and the unbatched mssd / mspd against JAX's:
    1e-5 relative (both f32)."""
    Re, te, Rg, tg, Ks, pts = _pairs(seed=len(kind))
    sR, st = J.sym_arrays(SYMMETRIES[kind])
    want = J.batched_bop_errors(*(jnp.asarray(a) for a in (Re, te, Rg, tg, Ks, pts, sR, st)))
    got = P.batched_bop_errors(Re, te, Rg, tg, Ks, pts, sR, st, device="cpu")
    for key in ("mssd", "mspd"):
        assert got[key].dtype == torch.float32 and got[key].shape == (len(Re),)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, err_msg=key)
    t = [torch.from_numpy(a) for a in (Re, te, Rg, tg, Ks, pts, sR, st)]
    one = P.mssd(t[0][3], t[1][3], t[2][3], t[3][3], t[5], t[6], t[7])
    np.testing.assert_allclose(float(one), float(want["mssd"][3]), rtol=1e-5)
    one = P.mspd(t[0][3], t[1][3], t[2][3], t[3][3], t[4][3], t[5], t[6], t[7])
    np.testing.assert_allclose(float(one), float(want["mspd"][3]), rtol=1e-5)


def test_batched_errors_chunk_over_pairs(monkeypatch):
    """Chunks of 2 pairs give the one-chunk result bit for bit, and GT poses
    give 0 under every symmetry set."""
    Re, te, Rg, tg, Ks, pts = _pairs(seed=5, n=7)
    sR, st = P.sym_arrays(SYMMETRIES["continuous"])
    whole = P.batched_bop_errors(Re, te, Rg, tg, Ks, pts, sR, st, device="cpu")
    monkeypatch.setattr(P, "_PAIR_BLOCK", 2 * 3 * len(sR) * len(pts))
    parts = P.batched_bop_errors(Re, te, Rg, tg, Ks, pts, sR, st, device="cpu")
    for key in whole:
        assert torch.equal(whole[key], parts[key])
    zero = P.batched_bop_errors(Rg, tg, Rg, tg, Ks, pts, sR, st, device="cpu")
    assert float(zero["mssd"].max()) == 0.0 and float(zero["mspd"].max()) == 0.0


def test_mspd_clamps_depth_like_jax():
    """An estimate with vertices behind the camera: both clamp z at 1e-6."""
    Re, te, Rg, tg, Ks, pts = _pairs(seed=9, n=4)
    te = te.copy()
    te[:, 2] = 10.0                               # the cloud straddles z = 0
    sR, st = J.sym_arrays({})
    want = J.batched_bop_errors(*(jnp.asarray(a) for a in (Re, te, Rg, tg, Ks, pts, sR, st)))
    got = P.batched_bop_errors(Re, te, Rg, tg, Ks, pts, sR, st, device="cpu")
    assert float(got["mspd"].min()) > 1e6
    np.testing.assert_allclose(got["mspd"].numpy(), np.asarray(want["mspd"]), rtol=1e-5)


def test_bop19_average_recall_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        e1 = rng.uniform(0, 80, 50)
        e1[rng.random(50) < 0.1] = np.inf
        e2 = rng.uniform(0, 70, 50)
        args = (e1, e2, float(rng.uniform(50, 200)), int(rng.choice([640, 720, 1280])))
        assert P.bop19_average_recall(*args) == J.bop19_average_recall(*args)


def _random_groups(rng, n_groups=12):
    groups = []
    for _ in range(n_groups):
        n_gt = int(rng.integers(1, 4))
        ests = [{"score": float(rng.choice([0.5, 0.9, rng.random()])),
                 "errors": {g: float(rng.uniform(0, 0.6)) for g in range(n_gt)
                            if rng.random() < 0.8}}
                for _ in range(int(rng.integers(0, 5)))]
        groups.append({"ests": ests, "gt_valid": list(rng.random(n_gt) < 0.8),
                       "n_top": int(rng.integers(-1, 3))})
    return groups


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matching_and_official_recall_match_jax(seed):
    rng = np.random.default_rng(seed)
    groups = _random_groups(rng)
    for g in groups:
        for th in (0.1, 0.25, 0.5):
            for max_ests in (-1, 0, 1, 2):
                assert P.match_poses_greedy(g["ests"], th, max_ests, g["gt_valid"]) == \
                    J.match_poses_greedy(g["ests"], th, max_ests, g["gt_valid"])
    for th in (J.MSSD_THRESHOLDS, J.MSPD_THRESHOLDS / 100.0, np.arange(0.05, 0.51, 0.05)):
        assert P.official_average_recall(groups, th) == J.official_average_recall(groups, th)
    np.testing.assert_array_equal(P.MSSD_THRESHOLDS, J.MSSD_THRESHOLDS)
    np.testing.assert_array_equal(P.MSPD_THRESHOLDS, J.MSPD_THRESHOLDS)
    np.testing.assert_array_equal(P.VSD_TAUS, J.VSD_TAUS)
    assert P.VSD_DELTA == J.VSD_DELTA


def test_csv_check_and_load_match_jax(tmp_path):
    good = "1,2,3,0.5,1 0 0 0 1 0 0 0 1,10 20 400,-1\n"
    lines = ["scene_id,im_id,obj_id,score,R,t,time\n", good,
             "1,3,3,0.7,1 0 0 0 1 0 0 0 1,10 20 400,0.25\n",
             "1,4,3,0.5,1 0 0 0 1 0 0 0,10 20 400,-1\n",          # 8 values of R
             "1,5,3,0.5,1 0 0 0 1 0 0 0 1,10 20,-1\n",            # 2 of t
             "1,x,3,0.5,1 0 0 0 1 0 0 0 1,10 20 400,-1\n",        # not an int
             "1,6,3,0.5\n",                                       # 4 fields
             "2,7,3,0.9,0 1 0 -1 0 0 0 0 1,-5 3 512.25,1e-3\n"]
    path = tmp_path / "r.csv"
    path.write_text("".join(lines))
    assert P.check_bop_results_csv(str(path)) == J.check_bop_results_csv(str(path))
    assert len(P.check_bop_results_csv(str(path))) == 4
    bad_header = tmp_path / "h.csv"
    bad_header.write_text("scene,im\n" + good)
    assert P.check_bop_results_csv(str(bad_header)) == J.check_bop_results_csv(str(bad_header))
    # a line without 7 fields is skipped by the loader of both
    ok = tmp_path / "ok.csv"
    ok.write_text("".join(lines[:3] + lines[6:]))
    got, want = P.load_bop_results_csv(str(ok)), J.load_bop_results_csv(str(ok))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # an R without 9 values or an id that is no int raises in both; a t
    # without 3 values loads as it is in both
    one = tmp_path / "bad.csv"
    for bad in (lines[3], lines[5]):
        one.write_text(lines[0] + bad)
        with pytest.raises(ValueError):
            J.load_bop_results_csv(str(one))
        with pytest.raises(ValueError):
            P.load_bop_results_csv(str(one))
    one.write_text(lines[0] + lines[4])
    (got,), (want,) = P.load_bop_results_csv(str(one)), J.load_bop_results_csv(str(one))
    np.testing.assert_array_equal(got["t"], want["t"])


def test_depth_to_dist_matches_jax():
    rng = np.random.default_rng(4)
    depth = (rng.uniform(0, 1000, (48, 64)) * (rng.random((48, 64)) < 0.7)).astype(np.float32)
    Kc = K.copy()
    Kc[0, 2], Kc[1, 2] = 30.5, 22.0
    np.testing.assert_allclose(P.depth_to_dist(depth, Kc), J.depth_to_dist(depth, Kc),
                               rtol=1e-6, atol=0)


def _mesh(rng, n_verts=40, n_faces=70):
    """A random triangle soup with a few degenerate triangles (a repeated
    vertex, three collinear vertices)."""
    v = rng.uniform(-40, 40, (n_verts, 3))
    v[-3:] = [[0, 0, 0], [10, 10, 10], [20, 20, 20]]          # collinear
    f = rng.integers(0, n_verts - 3, (n_faces, 3))
    f[0] = [1, 1, 2]
    f[1] = [n_verts - 3, n_verts - 2, n_verts - 1]
    return v, f.astype(np.int32)


@pytest.mark.parametrize("case", ["vga", "wide_1280", "behind_camera"])
def test_render_depth_matches_jax(case):
    """Same buckets, chunking, culling and z-buffer as the JAX renderer:
    exact, on random meshes and poses (a 1280-wide frame takes the extra
    bucket; faces behind the camera are culled)."""
    rng = np.random.default_rng({"vga": 0, "wide_1280": 1, "behind_camera": 2}[case])
    w, h = (1280, 720) if case == "wide_1280" else (640, 480)
    for _ in range(3):
        v, f = _mesh(rng)
        R = _rotations(rng, 1)[0]
        t = np.array([rng.uniform(-30, 30), rng.uniform(-30, 30), rng.uniform(150, 500)])
        if case == "behind_camera":
            t[2] = 20.0                          # some vertices at z < 0
        if case == "wide_1280":
            v = v * 6.0                          # triangles wider than 1024 px
        Kc = K.copy()
        Kc[0, 2], Kc[1, 2] = w / 2, h / 2
        want = jrenderer.render_depth(v, f, R, t, Kc, w, h)
        got = prenderer.render_depth(v, f, R, t, Kc, w, h)
        assert got.dtype == np.float32 and got.shape == (h, w)
        assert (got > 0).any()
        np.testing.assert_array_equal(got, want)


def _vsd_scene(seed):
    rng = np.random.default_rng(seed)
    v, f = _mesh(rng, 60, 120)
    R_gt = _rotations(rng, 1)[0]
    t_gt = np.array([5.0, -8.0, 420.0])
    depth = jrenderer.render_depth(v, f, R_gt, t_gt, K)
    depth[:, :200] = np.where(depth[:, :200] > 0, 300.0, 0.0)      # an occluder
    depth = np.round(depth).astype(np.float32)                     # mm, as a PNG stores it
    R_est = _rotations(rng, 1)[0] * 0.05 + R_gt
    R_est = np.linalg.qr(R_est)[0] * np.sign(np.diag(np.linalg.qr(R_est)[1]))
    return v, f, R_gt, t_gt, R_est, t_gt + np.array([3.0, -2.0, 6.0]), depth


@pytest.mark.parametrize("cost_type", ["step", "tlinear"])
def test_vsd_error_matches_jax(cost_type):
    """vsd_error equal to JAX's, without and with the render cache (whose
    second call renders nothing new)."""
    v, f, R_gt, t_gt, R_est, t_est, depth = _vsd_scene(7)
    diameter = 120.0
    want = J.vsd_error(R_est, t_est, R_gt, t_gt, depth, K, v, f, diameter, cost_type=cost_type)
    got = P.vsd_error(R_est, t_est, R_gt, t_gt, depth, K, v, f, diameter, cost_type=cost_type)
    assert got == want and len(got) == len(P.VSD_TAUS) and 0.0 < min(got) <= max(got) <= 1.0
    cache = {}
    for _ in range(2):
        got = P.vsd_error(R_est, t_est, R_gt, t_gt, depth, K, v, f, diameter,
                          cost_type=cost_type, render_cache=cache, est_key="e", gt_key="g")
        assert got == want
    assert sorted(map(str, cache)) == sorted(["e", "g", str(("test", id(depth)))])
    gt = P.vsd_error(R_gt, t_gt, R_gt, t_gt, depth, K, v, f, diameter, cost_type=cost_type)
    assert gt == J.vsd_error(R_gt, t_gt, R_gt, t_gt, depth, K, v, f, diameter,
                             cost_type=cost_type)
    with pytest.raises(ValueError):
        P.vsd_error(R_est, t_est, R_gt, t_gt, depth, K, v, f, diameter, cost_type="square")
