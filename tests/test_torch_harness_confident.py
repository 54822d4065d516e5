"""The post-network stack of both eval harnesses on confident codes, each
with its own solver (the port's draws from a torch.Generator, JAX's from
split PRNG keys).

The network is replaced on both sides by one oracle forward, monkeypatched
where each harness builds its forward (`train/steps.py::make_pose_forward`):
+-8 logits of the GT codes (`make_code_labels` of the batch's pose, box and
K) with a seeded share of the bits flipped (0, 2 and 5%), the RoI logit
from the GT in-RoI bit and the seg probabilities from the GT masks, as in
tests/test_oracle_noise.py. Both `evaluate_pipeline`s run hard, soft and
adaptive decode under every filter on a fixture the JAX generator writes.
The decoded correspondences and n_valid agree exactly (the points of the
soft decode to the last place of f32, where the two sigmoids round
differently). The two solvers sample alike (Gumbel top-k over the valid
points; tests/test_torch_solver.py holds them equal on JAX's own
hypotheses) but draw differently, and at 2-5% flips one run's adx02 or
median error moves by several images between draws: so each side runs the
same 3 seeds, and the port's range of adx 2/5/10, AUC and median rotation
and translation error meets JAX's range widened by one image. At <= 2%
flips every run reaches adx10 >= 0.9. With one deterministic stand-in solver
in both harnesses every entry agrees (tests/test_torch_harness.py's
comparison)."""
import hashlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu.eval import harness as jharness
from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.data.bop_io import scan_bop_object
from checkerpose_tpu_torch.data.dataset import CropDataset, Loader
from checkerpose_tpu_torch.data.fps import load_keypoints_normed
from checkerpose_tpu_torch.eval import harness as pharness
from checkerpose_tpu_torch.ops import codes, geometry
from checkerpose_tpu_torch.ops.knn import knn_index
from torch_parity import (assert_reports_equal, few_torch_threads,  # noqa: F401 (fixture)
                          standin_solver)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

NPT, KNN, N_IMAGES, BATCH, STAGE = 256, 5, 24, 12, 3
RES = 2 ** (3 + STAGE)
LOGIT = 8.0
FLIPS = (0.0, 0.02, 0.05)
DECODES = ("hard", "soft", "adaptive")
SOLVER_SEEDS = (0, 1, 2)            # JAX's PRNG keys, the port's generator seeds
RATE_KEYS = ("adx02", "adx05", "adx10")


class OracleNet(torch.nn.Module):
    """Stands for the network in both harnesses: what they read of it is its
    id resolution and (the port's) device."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.eval()

    @staticmethod
    def output_res_log2(stage):
        return 3 + stage


def _key(image) -> str:
    return hashlib.sha1(np.ascontiguousarray(np.asarray(image)).tobytes()).hexdigest()


def _oracle_outputs(batch, p3d, flip, rng):
    """The forward's outputs for one batch, as numpy: +-LOGIT logits of the
    GT codes at RES with a `flip` share of the bits flipped, the ids they
    decode to, the GT in-RoI bit and the GT masks as seg probabilities."""
    proj = np.stack([geometry.project_pts(p3d, K, R, t)[0]
                     for K, R, t in zip(batch["cam_K"], batch["R"], batch["t"])])
    roi, x_id, y_id = geometry.make_code_labels(torch.from_numpy(proj).float(),
                                                torch.from_numpy(batch["bbox"]).float(), RES)
    out = {"roi_mask": roi.numpy()}
    L = int(math.log2(RES))
    for name, ids in (("x", x_id), ("y", y_id)):
        bits = codes.ids_to_codes(ids, L).numpy()
        bits = np.where(rng.random(bits.shape) < flip, 1 - bits, bits)
        out[f"{name}_logits"] = (LOGIT * (2.0 * bits - 1.0)).astype(np.float32)
        out[f"{name}_id"] = codes.codes_to_ids(torch.from_numpy(bits)).numpy()
    for name in ("visib", "full"):
        m = np.asarray(batch[f"mask_{name}"], np.float64)
        out[f"seg_{name}"] = (1.0 / (1.0 + np.exp(-LOGIT * (2.0 * m - 1.0)))).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    jax_make_synthetic_bop(root, n_objects=1, n_scenes=1, n_images=N_IMAGES, n_vertices=512,
                           folders=("test",))
    xyz, normed = load_keypoints_normed(root, "synth", 1, NPT)
    samples = scan_bop_object(root, "synth", "test", 1)
    ds = CropDataset(samples, xyz, is_train=False, crop_size_gt=RES)
    batches = list(common.with_p3d(Loader(ds, BATCH, shuffle=False, drop_last=False), normed))
    assert sum(int(b["n_real"]) for b in batches) == N_IMAGES
    rng = np.random.default_rng(0)
    oracle = {flip: {_key(b["image"]): _oracle_outputs(b, xyz, flip, rng) for b in batches}
              for flip in FLIPS}
    # decoded points carry up to one code cell of truncation error: the inlier
    # threshold is the mean cell of these crops (tests/test_oracle_noise.py)
    cell = float(np.mean(np.concatenate([b["bbox"][:, 2] for b in batches]))) / RES
    return dict(xyz=xyz, knn=knn_index(normed, KNN), batches=batches, oracle=oracle,
                cell=cell, net=OracleNet(),
                diameter=common.object_diameter({"bop_path": root, "dataset_name": "synth",
                                                 "obj_id": 1}))


def _patch_forward(monkeypatch, outputs):
    """Both harnesses' forward -> the oracle's outputs for the batch whose
    image it is given (JAX arrays to JAX's, CPU tensors to the port's)."""
    def jax_factory(net, knn_idx, stage):
        return lambda variables, b: {k: jnp.asarray(v)
                                     for k, v in outputs[_key(b["image"])].items()}

    def port_factory(net, knn_idx, stage):
        return lambda b: {k: torch.from_numpy(v) for k, v in outputs[_key(b["image"])].items()}

    monkeypatch.setattr(jharness.steps, "make_pose_forward", jax_factory)
    monkeypatch.setattr(pharness.steps, "make_pose_forward", port_factory)


def _record(monkeypatch, module, name, seen):
    """Wrap `module.name` so that each call's result lands in `seen` (numpy)."""
    real = getattr(module, name)

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append({k: np.asarray(v) for k, v in out.items()} if isinstance(out, dict)
                    else tuple(np.asarray(v) for v in out))
        return out

    monkeypatch.setattr(module, name, recording)


def _run_both(s, flip, decode, seeds, **kw):
    # at 5% flips a 6-point sample is clean with probability ~2.5%: 512
    # hypotheses, as tests/test_oracle_noise.py gives that rate
    kw = dict(stage=STAGE, num_hyp=512 if flip >= 0.05 else 128, reproj_thresh=s["cell"],
              decode_mode=decode, decode_conf_tau=3.0, **kw)
    jax_reps = [jharness.evaluate_pipeline(s["net"], s["knn"], None, s["batches"], s["xyz"],
                                           s["diameter"], seed=k, **kw) for k in seeds]
    port_reps = [pharness.evaluate_pipeline(s["net"], s["knn"], s["batches"], s["xyz"],
                                            s["diameter"], seed=k, **kw) for k in seeds]
    return jax_reps, port_reps


def _per_image(sols, errs, n_batches):
    """The recorded solver and error results of consecutive harness runs ->
    per run {mode: (re (n,), te (n,))}, a failed solve counting 180 degrees
    and an infinite translation error, as both harnesses count it."""
    modes = pharness.FILTER_MODES
    runs = []
    for at in range(0, len(sols), n_batches):
        run = {m: ([], []) for m in modes}
        for sol, err in zip(sols[at:at + n_batches], errs[at:at + n_batches]):
            ok = sol["success"].reshape(len(modes), -1) > 0.5
            for mi, m in enumerate(modes):
                run[m][0].append(np.where(ok[mi], err["re"].reshape(len(modes), -1)[mi], 180.0))
                run[m][1].append(np.where(ok[mi], err["te"].reshape(len(modes), -1)[mi], np.inf))
        runs.append({m: tuple(np.concatenate(v) for v in run[m]) for m in modes})
    return runs


def _meets(lo, hi, port_vals):
    """The range of the port's results over its solver seeds meets [lo, hi]."""
    return min(port_vals) <= hi + 1e-9 and max(port_vals) >= lo - 1e-9


def _median_rank_bounds(jax_runs):
    """The range of JAX's per-run medians widened by one item: from the
    smallest order statistic just below a JAX median to the largest just
    above one."""
    n = len(jax_runs[0])
    return (min(np.sort(v)[(n - 1) // 2 - 1] for v in jax_runs),
            max(np.sort(v)[n // 2 + 1] for v in jax_runs))


@pytest.mark.parametrize("decode", DECODES)
@pytest.mark.parametrize("flip", FLIPS)
def test_own_solvers_agree_on_oracle_codes(setup, monkeypatch, flip, decode):
    """Correspondences and n_valid exact. Over 3 solver seeds on each side,
    the range of the port's adx 2/5/10 and AUC meets JAX's range widened by
    1/n, and the range of its median rotation and translation errors meets
    JAX's range of medians widened by one rank; adx10 >= 0.9 at <= 2% flips
    in every run."""
    s = setup
    _patch_forward(monkeypatch, s["oracle"][flip])
    rec = {name: ([], []) for name in ("ids_to_correspondences", "solve_poses_batched",
                                       "batched_pose_errors")}
    for name, (seen_j, seen_p) in rec.items():
        _record(monkeypatch, jharness if name != "batched_pose_errors" else jharness.M, name,
                seen_j)
        _record(monkeypatch, pharness if name != "batched_pose_errors" else pharness.M, name,
                seen_p)
    jax_reps, port_reps = _run_both(s, flip, decode, SOLVER_SEEDS)
    seen_j, seen_p = rec["ids_to_correspondences"]
    assert len(seen_p) == len(seen_j) == \
        len(s["batches"]) * len(pharness.FILTER_MODES) * len(SOLVER_SEEDS)
    for (pj, vj), (pp, vp) in zip(seen_j, seen_p):
        np.testing.assert_array_equal(vp, vj)
        if decode == "soft":            # XLA's and torch's f32 sigmoid differ in the last place
            np.testing.assert_allclose(pp, pj, rtol=2.0 ** -22, atol=0)
        else:
            np.testing.assert_array_equal(pp, pj)
    jax_img, port_img = (_per_image(*(rec[name][side] for name in ("solve_poses_batched",
                                                                  "batched_pose_errors")),
                                    len(s["batches"])) for side in (0, 1))
    for mode in pharness.FILTER_MODES:
        for key in ("n_valid_mean", "n_valid_lt6_frac"):
            assert {r[mode][key] for r in jax_reps} == {r[mode][key] for r in port_reps}, \
                (mode, key)
        for key in (*RATE_KEYS, "auc_posecnn"):
            vals = [r[mode][key] for r in jax_reps]
            got = [r[mode][key] for r in port_reps]
            assert _meets(min(vals) - 1.0 / N_IMAGES, max(vals) + 1.0 / N_IMAGES, got), \
                (mode, key, vals, got)
        for col, name in enumerate(("re", "te")):
            lo, hi = _median_rank_bounds([r[mode][col] for r in jax_img])
            medians = [float(np.median(r[mode][col])) for r in port_img]
            assert _meets(lo, hi, medians), (mode, name, lo, hi, medians)
        if flip <= 0.02:
            assert min(r[mode]["adx10"] for r in jax_reps + port_reps) >= 0.9, mode
    for r in port_reps:
        np.testing.assert_allclose(r["bit_err"], jax_reps[0]["bit_err"], rtol=1e-6, atol=1e-7)
    if flip == 0.0:
        assert max(port_reps[0]["bit_err"]) == 0.0


# a rotation error is the arccos of an f32 cosine: near 0 it is resolved to
# about sqrt(2 * 2**-24) rad, so the two harnesses' mean may differ by that
RE_RESOLUTION_DEG = float(np.degrees(np.sqrt(2.0 * 2.0 ** -24)))


@pytest.mark.parametrize("decode", ("hard", "adaptive"))
@pytest.mark.parametrize("flip", FLIPS)
def test_standin_solver_reports_equal_on_oracle_codes(setup, monkeypatch, flip, decode):
    """Every entry as tests/test_torch_harness.py compares them, the mean
    rotation error to the f32 arccos resolution (the rotations are within a
    degree of the truth). Soft decode is held by the test above only: its
    points differ in the last place, which a RANSAC inlier test at the
    threshold can turn into another pose."""
    s = setup
    _patch_forward(monkeypatch, s["oracle"][flip])
    monkeypatch.setattr(jharness, "solve_poses_batched", standin_solver)
    monkeypatch.setattr(pharness, "solve_poses_batched", standin_solver)
    (ref,), (got,) = _run_both(s, flip, decode, (0,), vertices=s["xyz"][::2])
    assert got["n_images"] == N_IMAGES and got["none"]["n_valid_mean"] > 0
    for mode in pharness.FILTER_MODES:
        assert abs(got[mode]["mean_re_deg"] - ref[mode]["mean_re_deg"]) <= RE_RESOLUTION_DEG
        got[mode] = dict(got[mode], mean_re_deg=ref[mode]["mean_re_deg"])
    assert_reports_equal(ref, got)
