"""Port eval/harness.py against the JAX package's, small networks on the CPU.

Both harnesses get the same numpy batches (the port's data path over a
fixture written by the JAX package's generator) and the same weights
(models/convert.py), in f32. Their solvers draw differently (a device
torch.Generator against split PRNG keys), so `solve_poses_batched` is
replaced in both harness modules by one deterministic stand-in: the port's
solver with fixed hypothesis indices, its result handed to each side as
its own arrays. The rest is compared entry by entry: the decode modes and
filters, filter_judge_bits, ADD/re/te, AUC, pass rates, seg metrics, bit
errors and the exported poses. The last test runs the port harness with its
own solver."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu.eval import harness as jharness
from checkerpose_tpu.models import InitNet as FlaxInitNet, PoseNet as FlaxPoseNet
from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.data.bop_io import scan_bop_object
from checkerpose_tpu_torch.data.dataset import CropDataset, Loader
from checkerpose_tpu_torch.data.detections import attach_detections, load_detections
from checkerpose_tpu_torch.data.fps import load_keypoints_normed
from checkerpose_tpu_torch.eval import harness as pharness
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.posenet import PoseNet
from checkerpose_tpu_torch.ops.knn import knn_index
from torch_parity import (N_HYP, assert_reports_equal,  # noqa: F401 (fixture)
                          few_torch_threads, load_port, random_variables, standin_solver)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

NPT, KNN = 16, 5
CFG = dict(npoint=NPT, res_log2=6, backbone_name="hrnet_w18_small", num_graph_module=1,
           init_num_graph_module=1, local_k=2)
INIT_CFG = dict(npoint=NPT, res_log2=3, backbone_name="hrnet_w18_small", num_graph_module=1)
@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    jax_make_synthetic_bop(root, n_objects=1, n_scenes=1, n_images=5, n_vertices=64,
                           folders=("test",))
    xyz, normed = load_keypoints_normed(root, "synth", 1, NPT)
    knn = knn_index(normed, KNN)
    samples = scan_bop_object(root, "synth", "test", 1)
    samples = attach_detections(samples, load_detections(
        f"{root}/detection_results/synth/synth_detections.json", 1))
    samples[2].detect_bbox = None                          # a missed detection: valid = 0
    ds = CropDataset(samples, xyz, is_train=False, crop_size_gt=64, use_detections=True)
    batches = list(common.with_p3d(Loader(ds, 3, shuffle=False, drop_last=False), normed))
    fnet = FlaxPoseNet(**CFG, dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, 256, 256, 3)), knn,
                                 jnp.zeros((1, NPT, 3)), stage=3, train=False,
                                 bn_scale=(0.3, 0.6))
    net = load_port(PoseNet(**CFG, dtype=torch.float32), variables)
    return dict(root=root, xyz=xyz, normed=normed, knn=knn, batches=batches, fnet=fnet,
                variables=variables, net=net,
                diameter=common.object_diameter({"bop_path": root, "dataset_name": "synth",
                                                 "obj_id": 1}))


@pytest.mark.parametrize("decode_mode,judge_bits,bd", [("hard", None, 0), ("soft", 3, 0),
                                                      ("adaptive", None, 2)])
def test_evaluate_pipeline_matches_jax(setup, monkeypatch, decode_mode, judge_bits, bd):
    s = setup
    monkeypatch.setattr(jharness, "solve_poses_batched", standin_solver)
    monkeypatch.setattr(pharness, "solve_poses_batched", standin_solver)
    kw = dict(stage=3, num_hyp=N_HYP, decode_mode=decode_mode, decode_conf_tau=1.0,
              filter_judge_bits=judge_bits, discard_bd_pixel=bd, main_filter="full",
              vertices=s["xyz"][::2])
    ref = jharness.evaluate_pipeline(s["fnet"], s["knn"], s["variables"], s["batches"],
                                     s["xyz"], s["diameter"], **kw)
    got = pharness.evaluate_pipeline(s["net"], s["knn"], s["batches"], s["xyz"],
                                     s["diameter"], **kw)
    assert got["n_images"] == 5 and sum(p["score"] == -1.0 for p in got["poses"]) >= 1
    assert_reports_equal(ref, got)


def test_calibrate_tau_and_empty_loader_match_jax(setup, monkeypatch):
    s = setup
    monkeypatch.setattr(jharness, "solve_poses_batched", standin_solver)
    monkeypatch.setattr(pharness, "solve_poses_batched", standin_solver)
    kw = dict(stage=3, num_hyp=N_HYP, taus=(0.5, 2.0), reproj_thresh=40.0)
    ref = jharness.calibrate_decode_tau(s["fnet"], s["knn"], s["variables"],
                                        lambda: s["batches"], s["xyz"], s["diameter"], **kw)
    got = pharness.calibrate_decode_tau(s["net"], s["knn"], lambda: s["batches"], s["xyz"],
                                        s["diameter"], **kw)
    assert got[0] == ref[0] and sorted(got[1]) == sorted(ref[1])
    np.testing.assert_allclose([got[1][t] for t in sorted(got[1])],
                               [ref[1][t] for t in sorted(ref[1])])
    ref = jharness.evaluate_pipeline(s["fnet"], s["knn"], s["variables"], [], s["xyz"],
                                     s["diameter"], stage=3)
    got = pharness.evaluate_pipeline(s["net"], s["knn"], [], s["xyz"], s["diameter"], stage=3)
    assert_reports_equal(ref, got)


def test_evaluate_init_matches_jax(setup):
    s = setup
    fnet = FlaxInitNet(**INIT_CFG, dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, 256, 256, 3)), s["knn"], False,
                                 bn_scale=(0.3, 0.6))
    net = load_port(InitNet(**INIT_CFG, dtype=torch.float32), variables)
    for metric in (None, "mean_bit_acc"):
        ref = jharness.evaluate_init(fnet, s["knn"], variables,
                                     [dict(b) for b in s["batches"]], 64, metric)
        got = pharness.evaluate_init(net, s["knn"], s["batches"], 64, metric)
        assert_reports_equal(ref, got)
    ref = jharness.evaluate_init(fnet, s["knn"], variables, [], 64)
    got = pharness.evaluate_init(net, s["knn"], [], 64)
    assert_reports_equal(ref, got)


def test_port_harness_with_its_own_solver(setup):
    """Unpatched: the report has the JAX harness's keys, every rate lies in
    [0, 1], the same seed gives the same poses, and the per-phase spans are
    filled when asked for."""
    s = setup
    spans = {}
    runs = [pharness.evaluate_pipeline(s["net"], s["knn"], s["batches"], s["xyz"],
                                       s["diameter"], stage=3, num_hyp=32, seed=3,
                                       spans=spans if i else None) for i in range(2)]
    a, b = runs
    assert sorted(a) == ["bit_err", "full", "n_images", "none", "poses", "seg_acc", "seg_iou",
                         "test_acc", "visib"]
    assert sorted(a["none"]) == sorted(pharness._MODE_KEYS)
    for mode in pharness.FILTER_MODES:
        for k in ("adx02", "adx05", "adx10", "rete2", "rete5", "re2", "re5", "te2", "te5",
                  "n_valid_lt6_frac"):
            assert 0.0 <= a[mode][k] <= 1.0
    for pa, pb in zip(a["poses"], b["poses"]):
        np.testing.assert_array_equal(pa["R"], pb["R"])
    assert sorted(spans) == ["aggregate", "forward_decode", "loader", "solver_metrics"]
    assert {len(v) for v in spans.values()} == {len(s["batches"])}
    net = s["net"].train()
    try:
        with pytest.raises(RuntimeError, match="eval mode"):
            pharness.evaluate_pipeline(net, s["knn"], s["batches"], s["xyz"], 1.0, stage=3)
    finally:
        net.eval()
