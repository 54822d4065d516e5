"""The fused RANSAC-EPnP kernel (csrc/ransac.cu through solver/fused.py)
against the eager chain (solver/ransac.py) on the same hypotheses.

On the CPU: the route rule, the counter, the wrappers' plumbing (the kernel
replaced by a recording stand-in) and the kernel's source itself, compiled
with g++ against tests/cuda_host_shim.h and run through the port's own
wrappers. The card tests (marker `gpu`) run both routes on the card and
import neither JAX nor the JAX package:
`python -m pytest -m gpu tests/test_torch_solver_kernel.py`.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from checkerpose_tpu_torch.eval.decode import ids_to_correspondences
from checkerpose_tpu_torch.ops import _build
from checkerpose_tpu_torch.ops.edgeconv import edgeconv_fused, reset_launch_counts
from checkerpose_tpu_torch.ops.geometry import make_code_labels, project_pts
from checkerpose_tpu_torch.solver import fused, ransac
from checkerpose_tpu_torch.solver.ransac import (FAST_PROFILE, eager_hypotheses, ransac_pnp,
                                                 sample_hypotheses, solve_poses_batched,
                                                 solver_route)
from checkerpose_tpu_torch.utils import counters
from chip_smoke import eager_under_signs, solver_departs, solver_departures
from torch_parity import LM_K as K
from torch_parity import pnp_problems, random_rotation, require_cuda, rot_deg

SETTINGS = {
    "fast_profile": dict(FAST_PROFILE),
    "test_lm_reseed": dict(num_hyp=128, refine_iters=8, n_backtrack=3, reseed=True),
    "soft_coherence_reseed": dict(num_hyp=32, soft_inlier_sigma=0.5, coherence_weight=0.1,
                                  refine_iters=4, reseed=True, n_backtrack=2),
    "irls_rounds_0": dict(num_hyp=64, irls_rounds=0),
    # past one block's worth of hypotheses, 9-point samples, two passes of
    # Gauss-Newton candidates, three IRLS rounds
    "many_hypotheses": dict(num_hyp=300, sample_size=9, refine_iters=3, n_backtrack=5,
                            irls_rounds=3, reseed=False),
}


@pytest.mark.parametrize("device,N,S,route", [
    ("cuda", 512, 6, "fused"),
    ("cuda", fused.MAX_N, fused.MAX_SAMPLE, "fused"),
    ("cpu", 512, 6, "eager"),
    ("cuda", fused.MAX_N + 1, 6, "eager"),
    ("cuda", 512, fused.MAX_SAMPLE + 1, "eager"),
    ("cuda", 0, 6, "eager"),
])
def test_solver_route(device, N, S, route):
    assert solver_route(torch.device(device), N, S) == route
    assert solver_route(device, N, S) == route


def test_cpu_solve_counts_eager_calls_and_reset_zeroes_both():
    """Two stages a call on the eager route, none on the kernel's; the one
    reset (imported from the EdgeConv op or from utils/counters.py) zeroes
    the solver's counts and the EdgeConv op's together, in place."""
    counts = ransac_pnp.launches_by_route
    reset_launch_counts()
    p3d, p2d, valid, _, _, _ = pnp_problems(2, 32, seed=0)
    for _ in range(2):
        solve_poses_batched(p3d, p2d, valid, K, torch.Generator().manual_seed(0),
                            device="cpu", **FAST_PROFILE)
    assert ransac_pnp.launches_by_route == {"fused": 0, "eager": 2 * 2}
    ransac_pnp.launches_by_route["fused"] = 5
    edgeconv_fused.launches_by_route["tc"] = 3
    reset_launch_counts()
    assert ransac_pnp.launches_by_route == {"fused": 0, "eager": 0}
    assert edgeconv_fused.launches_by_route == {"tc": 0, "fma": 0}
    counts["eager"] = 1
    counters.reset_launch_counts()
    assert ransac_pnp.launches_by_route is counts is fused.launches_by_route
    assert counts == {"fused": 0, "eager": 0}


@pytest.mark.parametrize("module,absent", [
    ("checkerpose_tpu_torch.ops.edgeconv", "checkerpose_tpu_torch.solver.ransac"),
    ("checkerpose_tpu_torch.solver.ransac", "checkerpose_tpu_torch.ops.edgeconv"),
])
def test_counters_keep_the_layers_apart(module, absent):
    """The EdgeConv op and the solver each import the one reset, not each
    other."""
    code = (f"import sys, {module}; assert {absent!r} not in sys.modules, "
            f"sorted(m for m in sys.modules if m.startswith('checkerpose'))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr


def test_fused_route_passes_rows_in_place_and_counts_two_launches(monkeypatch):
    """With the kernel replaced by a recorder: a stride-0 p3d and K reach it
    as their own storage with row stride 0, the shapes and counts as the
    caller passed them, two launches counted a call."""
    calls = []

    class Recorder:
        _typed = True

        def ransac_hypotheses_launch(self, *args):
            calls.append(("hypotheses", args))
            return 0

        def ransac_refine_launch(self, *args):
            calls.append(("refine", args))
            return 0

    monkeypatch.setattr(fused, "_lib", Recorder)
    monkeypatch.setattr(fused, "_stream", lambda t: 7)
    monkeypatch.setattr(ransac, "solver_route", lambda *a: "fused")
    reset_launch_counts()
    B, N = 3, 20
    p3 = torch.randn(N, 3)
    Kt = torch.from_numpy(K)
    hyp = torch.zeros(B, 5, 6, dtype=torch.int64)
    out = ransac_pnp(p3.expand(B, N, 3), torch.randn(B, N, 2), torch.ones(B, N),
                     Kt.expand(B, 3, 3), hyp_idx=hyp, refine_iters=4, n_backtrack=2,
                     irls_rounds=3, reseed=False, reproj_thresh=1.5)
    assert [c[0] for c in calls] == ["hypotheses", "refine"]
    h, r = calls[0][1], calls[1][1]
    assert (h[0], h[1], h[4], h[5]) == (p3.data_ptr(), 0, Kt.data_ptr(), 0)
    assert h[6] == hyp.data_ptr() and h[7:11] == (B, N, 5, 6) and h[11] == 1.5
    assert r[7:9] == (B, N) and r[13:17] == (4, 2, 3, 0) and r[-1] == 7
    assert ransac_pnp.launches_by_route == {"fused": 2, "eager": 0}
    assert out["R"].shape == (B, 3, 3) and out["inliers"].shape == (B, N)
    assert out["success"].dtype == torch.bool
    # a launch outside ransac_pnp counts too: the count sits next to it
    fused.hypotheses(p3.expand(B, N, 3), torch.randn(B, N, 2), torch.ones(B, N),
                     Kt.expand(B, 3, 3), hyp, 1.5, 0.0)
    assert ransac_pnp.launches_by_route == {"fused": 3, "eager": 0}
    reset_launch_counts()


def _answers(R_deg, t_off, best, success=True):
    """(answer, best hypothesis) rows about the z axis: rotations R_deg from
    the identity, translations t_off from the origin along x."""
    th = np.radians(np.asarray(R_deg, np.float64))
    R = np.zeros((th.size, 3, 3))
    R[:, 0, 0] = R[:, 1, 1] = np.cos(th)
    R[:, 0, 1], R[:, 1, 0], R[:, 2, 2] = -np.sin(th), np.sin(th), 1.0
    t = np.zeros((th.size, 3))
    t[:, 0] = t_off
    return ({"R": R, "t": t, "num_inliers": np.full(th.size, 100.0),
             "success": np.full(th.size, success)}, np.asarray(best))


@pytest.mark.parametrize("kern,signs,raises", [
    ((0.3, 0.4, 0.0), None, None),                      # departs, as near the truth
    ((30.0, 0.4, 0.0), None, "farther from the truth"),
    ((30.0, 0.4, 0.0), (29.0, 0.0), None),              # the eager answer under another sign
    ((30.0, 0.4, 0.0), (1.0, 0.0), "farther from the truth"),
    ((0.3, 40.0, 0.0), None, "farther from the truth"),
    ((0.3, 0.4, 1.0), None, "at most 1"),               # two rows depart
])
def test_solver_departures_holds_departing_rows_to_the_truth(kern, signs, raises):
    """chip_smoke.py's bar, shared with the card tests, on made-up answers:
    row 0 departs (another best hypothesis); its error to the truth (the
    identity) may exceed the eager answer's only as SOLVER_FARTHER allows, or
    as far as an eager answer under another covariance sign lands."""
    deg, t_off, deg1 = kern
    k = _answers([deg, deg1], [t_off, 0.0], [1, 0])
    e = _answers([0.2, 0.0], [0.3, 0.0], [0, 0])
    truth = (np.stack([np.eye(3)] * 2), np.zeros((2, 3)))
    alt = None if signs is None else (lambda rows: [_answers([signs[0]], [signs[1]], [0])[0]])
    if raises:
        with pytest.raises(AssertionError, match=raises):
            solver_departures(k, e, truth, 1, signs=alt)
    else:
        off, err, by_sign = solver_departures(k, e, truth, 1, signs=alt)
        assert off.tolist() == [0] and by_sign.tolist() == ([0] if signs else [])


def test_eager_under_signs_spans_the_covariance_signs():
    """The reseed EPnP's answer under each sign of the covariance's
    eigenvectors: the library's own signs give the eager chain's answer,
    and without the reseed no sign moves it."""
    B, N = 2, 64
    p3d, p2d, valid, _, _, _ = pnp_problems(B, N, seed=4, noise=0.7, outliers=0.2)
    args = (*map(torch.from_numpy, (p3d, p2d, valid)), torch.from_numpy(K).expand(B, 3, 3))
    hyp = sample_hypotheses(args[2], 8, 6, torch.Generator().manual_seed(1))
    for reseed in (True, False):
        kw = dict(num_hyp=8, refine_iters=3, reseed=reseed)
        plain = ransac_pnp(*(a[[1]] for a in args), hyp_idx=hyp[[1]], **kw)
        alts = eager_under_signs(args, hyp, [1], **kw)
        assert len(alts) == 8
        np.testing.assert_array_equal(alts[0]["R"], plain["R"].numpy())
        if not reseed:
            for alt in alts:
                np.testing.assert_array_equal(alt["R"], plain["R"].numpy())


# ---------------------------------------------------------------- host build

# the source's CUDA-only lines and their host forms; the extern "C" section
# (launch syntax, the runtime's attributes) gives way to HOST_LAUNCHES
HOST_SUBSTITUTIONS = [("#include <cuda_runtime.h>", '#include "cuda_host_shim.h"'),
                      ("extern __shared__ float smem[];", "float* smem = shim_dynamic_smem();")]
HOST_LAUNCHES = r"""
extern "C" {
int ransac_max_n() { return MAX_N; }
int ransac_max_sample() { return MAX_S; }
size_t ransac_hypotheses_smem_bytes(int N, int S) { return hypotheses_smem(N, S); }
size_t ransac_refine_smem_bytes(int N, int coherence) { return refine_smem(N, coherence); }
int ransac_hypotheses_launch(const float* p3d, long long p3d_bs, const float* p2d,
                             const float* valid, const float* K, long long K_bs,
                             const long long* hyp, int B, int N, int H, int S, float thresh,
                             float soft_sigma, float* pose, int* best, void*) {
  shim_launch(B, THREADS, hypotheses_smem(N, S), [&] {
    ransac_hypotheses(p3d, p3d_bs, p2d, valid, K, K_bs, hyp, N, H, S, thresh, soft_sigma,
                      pose, best);
  });
  return 0;
}
int ransac_refine_launch(const float* p3d, long long p3d_bs, const float* p2d, const float* valid,
                         const float* K, long long K_bs, const float* pose0, int B, int N,
                         float thresh, float soft_sigma, float coherence, float radius2,
                         int iters, int n_backtrack, int irls_rounds, int reseed, float* R,
                         float* t, float* inliers, float* num_inliers, unsigned char* success,
                         void*) {
  const Params pr{thresh, soft_sigma, coherence, radius2, iters, n_backtrack, irls_rounds, reseed};
  shim_launch(B, THREADS, refine_smem(N, coherence > 0.f), [&] {
    ransac_refine(p3d, p3d_bs, p2d, valid, K, K_bs, pose0, N, pr, R, t, inliers, num_inliers,
                  success);
  });
  return 0;
}
}
"""


def host_source(src: str) -> str:
    """csrc/ransac.cu for the host: each substitution applied (raises where
    one no longer does), the extern "C" section replaced."""
    for old, new in HOST_SUBSTITUTIONS:
        if old not in src:
            raise ValueError(f"{old!r} is not in csrc/ransac.cu")
        src = src.replace(old, new)
    return src[:src.index('extern "C" {')] + HOST_LAUNCHES


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's source built for the CPU (g++, one thread a CUDA thread)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    out = tmp_path_factory.mktemp("ransac_host")
    src = out / "ransac_host.cpp"
    src.write_text(host_source(_build.SOURCES["ransac"].read_text()))
    lib = out / "libransac_host.so"
    res = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
                          f"-I{Path(__file__).parent}", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ could not build csrc/ransac.cu for the host:\n{res.stderr}")
    return fused.typed(ctypes.CDLL(str(lib)))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_kernel_source_on_the_host_matches_eager(monkeypatch, host_kernel, setting):
    """The kernel's arithmetic and control flow, run on the CPU through the
    port's wrappers (route "fused" on CPU tensors), against the eager chain
    on the same hypotheses, both in the host's f32: every row within the bar
    the eager chain holds against the JAX solver. The reseed EPnP takes its
    control points from the covariance's eigenvectors, whose signs each
    eigensolver picks freely, and EPnP on noisy points depends on them (as
    tests/test_torch_solver.py::test_epnp_matches_jax says): settings with
    the reseed are held on exact correspondences among the outliers."""
    kw = dict(SETTINGS[setting])
    H, S = kw.pop("num_hyp"), kw.pop("sample_size", 6)
    B, N = 3, 80
    noise = 0.0 if kw.get("reseed") else 0.7
    p3d, p2d, valid, _, _, _ = pnp_problems(B, N, seed=21, noise=noise, outliers=0.2)
    p3d, p2d, valid = map(torch.from_numpy, (p3d, p2d, valid))
    Kb = torch.from_numpy(K).expand(B, 3, 3)
    hyp = sample_hypotheses(valid, H, S, torch.Generator().manual_seed(6))
    monkeypatch.setattr(fused, "_lib", lambda: host_kernel)
    monkeypatch.setattr(fused, "_stream", lambda t: None)
    thresh, sigma = kw.get("reproj_thresh", 2.0), kw.get("soft_inlier_sigma", 0.0)
    with monkeypatch.context() as m:
        m.setattr(ransac, "solver_route", lambda *a: "fused")
        kern = ransac_pnp(p3d, p2d, valid, Kb, hyp_idx=hyp, **kw)
        kbest = fused.hypotheses(p3d, p2d, valid, Kb, hyp, thresh, sigma)[1]
    eager = ransac_pnp(p3d, p2d, valid, Kb, hyp_idx=hyp, **kw)
    ebest = eager_hypotheses(p3d, p2d, valid, Kb, hyp, thresh, sigma)[2]
    host = lambda d: {k: v.numpy() for k, v in d.items()}  # noqa: E731
    rows = solver_departs((host(kern), kbest.numpy()), (host(eager), ebest.numpy()))
    assert not rows.any(), f"rows {np.flatnonzero(rows)} depart from the eager chain"
    np.testing.assert_array_equal(kern["inliers"].numpy() > 0.5,
                                  (kern["inliers"].numpy() > 0.5) & (valid.numpy() > 0.5))


@pytest.mark.parametrize("kw,noise", [
    (dict(soft_inlier_sigma=0.5, n_backtrack=3, irls_rounds=1, reseed=False), 0.7),
    (dict(soft_inlier_sigma=0.5, coherence_weight=0.1, n_backtrack=2, irls_rounds=2,
          reseed=False), 0.7),
    (dict(soft_inlier_sigma=0.5, n_backtrack=5, irls_rounds=2, reseed=True), 0.0),
], ids=["soft", "soft_coherence", "soft_reseed_exact"])
def test_kernel_refine_on_the_host_matches_eager_from_one_start(monkeypatch, host_kernel, kw,
                                                                 noise):
    """The refine launch and the eager refine from the same start, ~0.3 deg
    and ~0.5 units off the truth, one Gauss-Newton step a round, soft
    inliers: nothing thresholded and no near-tie among the step's
    candidates, so the two differ by summation order alone: rotation entries
    within 1e-5, translations within 1e-3 (the reseed on exact
    correspondences, for the eigenvectors' signs)."""
    B, N = 4, 64
    p3d, p2d, valid, _, Rs, ts = pnp_problems(B, N, seed=22, noise=noise, outliers=0.2)
    rng = np.random.default_rng(7)
    R0 = np.stack([_rodrigues(rng.normal(0, 0.005, 3)) @ R for R in Rs])
    pose0 = torch.from_numpy(np.concatenate(
        [R0.reshape(B, 9), ts + rng.normal(0, 0.5, ts.shape)], 1).astype(np.float32))
    p3d, p2d, valid = map(torch.from_numpy, (p3d, p2d, valid))
    Kb = torch.from_numpy(K).expand(B, 3, 3)
    monkeypatch.setattr(fused, "_lib", lambda: host_kernel)
    monkeypatch.setattr(fused, "_stream", lambda t: None)
    full = dict(reproj_thresh=2.0, refine_iters=1, coherence_weight=0.0,
                neighborhood_radius=20.0)
    full.update(kw)
    kern = fused.refine(p3d, p2d, valid, Kb, pose0, **full)
    eager = ransac._eager_refine(p3d, p2d, valid, Kb, pose0[:, :9].reshape(B, 3, 3),
                                 pose0[:, 9:], **full)
    np.testing.assert_allclose(kern["R"].numpy(), eager["R"].numpy(), atol=1e-5)
    np.testing.assert_allclose(kern["t"].numpy(), eager["t"].numpy(), atol=1e-3)
    np.testing.assert_array_equal(kern["inliers"].numpy(), eager["inliers"].numpy())
    np.testing.assert_array_equal(kern["success"].numpy(), eager["success"].numpy())
    assert rot_deg(kern["R"].numpy(), Rs).max() < 1.0


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


# ---------------------------------------------------------------- card


def _routes(monkeypatch, p3d, p2d, valid, Kb, hyp, cpu=False, **kw):
    """ransac_pnp on the same hypotheses through the kernel, through the
    eager chain on the card and (cpu) through the eager chain on the CPU:
    each route's answer and best hypothesis, on the host."""
    thresh = kw.get("reproj_thresh", 2.0)
    sigma = kw.get("soft_inlier_sigma", 0.0)
    host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}  # noqa: E731
    out = {}
    with torch.inference_mode():
        reset_launch_counts()
        kern = ransac_pnp(p3d, p2d, valid, Kb, hyp_idx=hyp, **kw)
        assert ransac_pnp.launches_by_route == {"fused": 2, "eager": 0}
        out["fused"] = (host(kern), fused.hypotheses(p3d, p2d, valid, Kb, hyp, thresh,
                                                      sigma)[1].cpu().numpy())
        inputs = {"eager": (p3d, p2d, valid, Kb, hyp)}
        if cpu:
            inputs["cpu"] = tuple(a.cpu() for a in inputs["eager"])
        with monkeypatch.context() as m:
            m.setattr(ransac, "solver_route", lambda *a: "eager")
            for name, args in inputs.items():
                sol = ransac_pnp(*args[:4], hyp_idx=args[4], **kw)
                best = eager_hypotheses(*args, thresh, sigma)[2]
                out[name] = (host(sol), best.cpu().numpy())
    reset_launch_counts()
    return out


def _violations(sol, p3d, p2d, valid, Kb, thresh):
    """posebench's check of what each answer claims, summed over the kinds."""
    from posebench.reference.poses import pose_violations
    t = {k: torch.as_tensor(v, device="cuda") for k, v in sol.items()}
    parts = pose_violations(t["R"], t["t"], t["inliers"], t["num_inliers"], t["success"],
                            valid, p3d, p2d, Kb, thresh, 1e-2)
    return int(sum(int(v.sum()) for v in parts.values()))


MAX_OFF = 8          # departing rows of 64 at most, whatever the CPU's eager chain does


@pytest.mark.gpu
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_fused_matches_eager_on_the_same_hypotheses(monkeypatch, setting):
    """The kernel against the eager chain on the card, on the same hypotheses
    of problems with noise and 20% outliers. A 6-point EPnP in f32 is
    ill-conditioned (inverse iteration on MtM + 1e-6 I) and inliers are
    thresholded, so another summation order moves a few rows past the bar:
    the eager chain on the CPU departs from it on the card too. The kernel
    departs in at most two rows more than that and in at most MAX_OFF;
    each row it departs in lands near the truth as the eager answer does
    (chip_smoke.py's SOLVER_FARTHER), or as the eager chain does under
    another sign of the covariance's eigenvectors, which each eigensolver
    picks freely and the reseed EPnP depends on; success alike in every
    row, and every answer holds what it claims."""
    require_cuda()
    kw = dict(SETTINGS[setting])
    H, S = kw.pop("num_hyp"), kw.pop("sample_size", 6)
    B, N = 64, 512
    p3d, p2d, valid, _, Rt, tt = pnp_problems(B, N, seed=11, noise=0.7, outliers=0.2)
    dev = torch.device("cuda")
    p3d, p2d, valid = (torch.from_numpy(a).to(dev) for a in (p3d, p2d, valid))
    Kb = torch.from_numpy(K).to(dev).expand(B, 3, 3)
    hyp = sample_hypotheses(valid, H, S, torch.Generator(dev).manual_seed(3))
    out = _routes(monkeypatch, p3d, p2d, valid, Kb, hyp, cpu=True, **kw)

    c_off = np.flatnonzero(solver_departs(out["cpu"], out["eager"]))
    solver_departures(out["fused"], out["eager"], (Rt, tt), min(MAX_OFF, len(c_off) + 2),
                      signs=lambda rows: eager_under_signs((p3d, p2d, valid, Kb), hyp, rows,
                                                           **kw))
    assert _violations(out["fused"][0], p3d, p2d, valid, Kb,
                       kw.get("reproj_thresh", 2.0)) == 0


@pytest.mark.gpu
def test_fused_at_the_largest_row_it_takes(monkeypatch):
    """N = MAX_N with coherence (the most shared memory a row takes) and the
    reseed EPnP on all N points."""
    require_cuda()
    B, N = 4, fused.MAX_N
    p3d, p2d, valid, _, _, _ = pnp_problems(B, N, seed=12, noise=0.7, outliers=0.2)
    dev = torch.device("cuda")
    p3d, p2d, valid = (torch.from_numpy(a).to(dev) for a in (p3d, p2d, valid))
    Kb = torch.from_numpy(K).to(dev).expand(B, 3, 3)
    kw = dict(SETTINGS["soft_coherence_reseed"])
    hyp = sample_hypotheses(valid, kw.pop("num_hyp"), 6, torch.Generator(dev).manual_seed(4))
    out = _routes(monkeypatch, p3d, p2d, valid, Kb, hyp, **kw)
    assert not solver_departs(out["fused"], out["eager"]).any()


@pytest.mark.gpu
def test_limits_mirror_the_c_functions():
    require_cuda()
    lib = fused._lib()
    assert (lib.ransac_max_n(), lib.ransac_max_sample()) == (fused.MAX_N, fused.MAX_SAMPLE)
    # the largest row's shared memory fits the 227 KB a block can use
    assert lib.ransac_refine_smem_bytes(fused.MAX_N, 1) <= 232448 - 1024
    assert lib.ransac_hypotheses_smem_bytes(fused.MAX_N, fused.MAX_SAMPLE) <= 232448 - 1024


@pytest.mark.gpu
def test_stride0_batches_give_the_materialised_answer():
    require_cuda()
    B, N = 16, 256
    p3d, p2d, valid, _, _, _ = pnp_problems(B, N, seed=13, noise=0.5, outliers=0.1)
    dev = torch.device("cuda")
    p3 = torch.from_numpy(p3d[0]).to(dev)
    p2d, valid = torch.from_numpy(p2d).to(dev), torch.from_numpy(valid).to(dev)
    Kt = torch.from_numpy(K).to(dev)
    hyp = sample_hypotheses(valid, 64, 6, torch.Generator(dev).manual_seed(5))
    with torch.inference_mode():
        a = ransac_pnp(p3.expand(B, N, 3), p2d, valid, Kt.expand(B, 3, 3), hyp_idx=hyp)
        b = ransac_pnp(p3.expand(B, N, 3).contiguous(), p2d, valid,
                       Kt.expand(B, 3, 3).contiguous(), hyp_idx=hyp)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
def test_oracle_codes_recover_pose_through_the_kernel():
    """tests/test_torch_solver.py::test_oracle_codes_recover_pose on the card,
    with the port's own projection and code labels."""
    require_cuda()
    rng = np.random.default_rng(0)
    N, B, S = 256, 4, 64
    p3d = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
    Rs, ts, rois, xs, ys, bboxes = [], [], [], [], [], []
    for i in range(B):
        R = random_rotation(np.random.default_rng(i))
        t = np.array([rng.uniform(-20, 20), rng.uniform(-20, 20), rng.uniform(350, 500)])
        uv = project_pts(p3d.astype(np.float64), K.astype(np.float64), R, t)[0]
        side = max(np.ptp(uv[:, 0]), np.ptp(uv[:, 1])) * 1.4
        bbox = np.array([uv[:, 0].min() - side * 0.15, uv[:, 1].min() - side * 0.15,
                         side, side], np.float32)
        roi, x, y = make_code_labels(torch.from_numpy(uv.astype(np.float32))[None],
                                     torch.from_numpy(bbox)[None], S)
        Rs.append(R); ts.append(t); rois.append(roi[0]); xs.append(x[0]); ys.append(y[0])
        bboxes.append(bbox)
    with torch.inference_mode():
        p2d, valid = ids_to_correspondences(torch.stack(xs), torch.stack(ys), torch.stack(rois),
                                            torch.from_numpy(np.stack(bboxes)), crop_size_gt=S)
    reset_launch_counts()
    sol = solve_poses_batched(p3d, p2d, valid, K, torch.Generator("cuda").manual_seed(0),
                              device="cuda", num_hyp=64)
    assert ransac_pnp.launches_by_route == {"fused": 2, "eager": 0}
    reset_launch_counts()
    for i in range(B):
        assert rot_deg(sol["R"][i].double().cpu().numpy(), Rs[i]) < 3.0
        assert np.linalg.norm(sol["t"][i].double().cpu().numpy() - ts[i]) < 10.0
        assert bool(sol["success"][i])


@pytest.mark.gpu
def test_degenerate_batch_fails_cleanly_through_the_kernel():
    """tests/test_torch_solver.py::test_degenerate_batch_fails_cleanly on the
    card: fewer than 4 valid points gives the identity and success False,
    collapsed correspondences nothing non-finite, and nothing raises."""
    require_cuda()
    p3d, p2d, valid, _, _, _ = pnp_problems(3, 20, seed=5)
    valid[0] = 0.0
    valid[0, :3] = 1.0
    p2d[1] = p2d[1, :1]                         # every point on one pixel
    reset_launch_counts()
    sol = solve_poses_batched(p3d, p2d, valid, K, torch.Generator("cuda").manual_seed(0),
                              device="cuda", **FAST_PROFILE)
    torch.cuda.synchronize()
    assert ransac_pnp.launches_by_route == {"fused": 2, "eager": 0}
    reset_launch_counts()
    assert not bool(sol["success"][0])
    np.testing.assert_array_equal(sol["R"][0].cpu().numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(sol["t"][0].cpu().numpy(), np.zeros(3, np.float32))
    assert bool(torch.isfinite(sol["R"]).all()) and bool(torch.isfinite(sol["t"]).all())
    assert bool(sol["success"][2])
