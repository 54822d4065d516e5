"""Port ServingPipeline vs the JAX ServingPipeline, the port's import rule,
its device convention, and a CPU rehearsal of chip_smoke.py's phases."""
import ast
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from checkerpose_tpu.models import PoseNet as FlaxPoseNet
from checkerpose_tpu.ops.geometry import pc_normalize
from checkerpose_tpu.ops.knn import knn_index
from checkerpose_tpu.serving import ServingPipeline as JaxServingPipeline
from checkerpose_tpu_torch.cli import test as cli_test
from checkerpose_tpu_torch.models.posenet import PoseNet, make_posenet
from checkerpose_tpu_torch.serving import ServingPipeline
from checkerpose_tpu_torch.solver.ransac import solve_poses_batched
from torch_parity import few_torch_threads, load_port, random_variables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

ROOT = Path(__file__).resolve().parents[1]
NPT, CROP, BATCH = 16, 256, 2
CFG = dict(npoint=NPT, res_log2=6, backbone_name="hrnet_w18_small", num_graph_module=3,
           init_num_graph_module=2, local_k=2)
K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    p3d = rng.uniform(-40, 40, (NPT, 3)).astype(np.float32)
    p3dn = pc_normalize(p3d).astype(np.float32)
    knn = knn_index(p3dn, 5)
    fnet = FlaxPoseNet(**CFG, dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, CROP, CROP, 3)), knn,
                                 jnp.zeros((1, NPT, 3)), stage=3, train=False,
                                 bn_scale=(0.3, 0.6))
    net = load_port(PoseNet(**CFG, dtype=torch.float32), variables)
    images = rng.integers(0, 255, (BATCH, CROP, CROP, 3)).astype(np.uint8)
    bbox = np.tile(np.array([[50., 60., 130., 130.]], np.float32), (BATCH, 1))
    return dict(fnet=fnet, variables=variables, net=net, knn=knn, p3d=p3d, p3dn=p3dn,
                images=images, bbox=bbox)


@pytest.mark.parametrize("decode_mode", ["hard", "soft", "adaptive"])
def test_correspondences_match_jax(setup, decode_mode):
    s = setup
    jp = JaxServingPipeline(s["fnet"], s["knn"], s["variables"], s["p3d"], s["p3dn"],
                            decode_mode=decode_mode)
    p3dn_b = jnp.broadcast_to(jnp.asarray(s["p3dn"])[None], (BATCH, NPT, 3))
    jp2d, jvalid = (np.asarray(a) for a in jp._stage1(
        s["variables"], jnp.asarray(s["images"]), jnp.asarray(s["bbox"]), p3dn_b))
    tp = ServingPipeline(s["net"], s["knn"], s["p3d"], s["p3dn"], decode_mode=decode_mode,
                         device="cpu")
    with torch.inference_mode():
        tp2d, tvalid = (a.numpy() for a in tp.correspondences(
            torch.from_numpy(s["images"]), torch.from_numpy(s["bbox"])))
    assert tp2d.shape == jp2d.shape == (BATCH, NPT, 2)
    # p2d is the decoded cell scaled into the bbox: where the decoded ids
    # agree it agrees to 0.05 px; demand that for nearly every keypoint
    same = np.abs(tp2d - jp2d).max(-1) < 0.05
    assert same.mean() > 0.95, same.mean()
    assert (tvalid[same] == jvalid[same]).mean() > 0.95


def test_pipeline_poses_and_stream(setup):
    s = setup
    pipe = ServingPipeline(s["net"], s["knn"], s["p3d"], s["p3dn"], device="cpu")
    batches = [(s["images"], s["bbox"], K),
               (s["images"][::-1].copy(), s["bbox"], K),
               (s["images"], s["bbox"] + 5.0, np.broadcast_to(K, (BATCH, 3, 3)).copy())]
    out = pipe(*batches[0], torch.Generator().manual_seed(3))
    assert out["R"].shape == (BATCH, 3, 3) and out["t"].shape == (BATCH, 3)
    assert bool(torch.isfinite(out["R"]).all()) and bool(torch.isfinite(out["t"]).all())
    g = torch.Generator().manual_seed(3)
    one_by_one = [{k: v.numpy() for k, v in pipe(*b, g).items()} for b in batches]
    streamed = list(pipe.stream(iter(batches), torch.Generator().manual_seed(3), depth=2))
    assert len(streamed) == len(batches)
    for a, b in zip(streamed, one_by_one):
        assert sorted(a) == ["R", "inliers", "num_inliers", "success", "t"]
        for k in a:
            assert isinstance(a[k], np.ndarray)
            np.testing.assert_array_equal(a[k], b[k])   # same order, same draws


def test_entry_points_default_to_the_card(setup):
    """device defaults to "cuda": without a card the entry points raise
    rather than fall back to the CPU."""
    s = setup
    if torch.cuda.is_available():
        assert ServingPipeline(s["net"], s["knn"], s["p3d"], s["p3dn"]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingPipeline(s["net"], s["knn"], s["p3d"], s["p3dn"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_posenet(**CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_poses_batched(s["p3d"], np.zeros((1, NPT, 2)), np.ones((1, NPT)), K,
                            hyp_idx=np.zeros((1, 4, 6), np.int64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test.main({})                        # before it reads any file


def test_pipeline_rejects_bad_graph_and_mode(setup):
    s = setup
    with pytest.raises(ValueError):
        ServingPipeline(s["net"], s["knn"] + NPT, s["p3d"], s["p3dn"], device="cpu")
    with pytest.raises(ValueError):
        ServingPipeline(s["net"], s["knn"], s["p3d"], s["p3dn"], decode_mode="fuzzy",
                        device="cpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*ROOT.glob("checkerpose_tpu_torch/**/*.py"), ROOT / "chip_smoke.py"]))
def test_port_imports_no_jax(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "checkerpose_tpu"), \
            (path, mod)


def test_chip_smoke_phases_rehearsed_on_cpu():
    dev = torch.device("cpu")
    rows = chip_smoke.phase_kernels(dev, B=1, N=32, K=4, widths=(64, 256), iters=1,
                                    plain_iters=1)
    # 2 widths + 1 ragged shape, each through tc/bf16, fma/f32 and fma/bf16
    assert len(rows) == 9 and all(r["ms"] is None for r in rows)
    assert sum(r["ragged"] for r in rows) == 3
    assert sorted({(r["kernel"], r["dtype"]) for r in rows}) == [
        ("fma", "bfloat16"), ("fma", "float32"), ("tc", "bfloat16")]
    serving = chip_smoke.phase_serving(dev, batch=2, npoint=NPT, backbone="hrnet_w18_small",
                                       warm=1, iters=1)
    assert serving["edgeconv_launches"] == 0 and serving["crops_per_s"] is None
    assert serving["edgeconv_launches_by_route"] == {"tc": 0, "fma": 0}
    ref = chip_smoke.phase_reference(dev, npoint=NPT, backbone="hrnet_w18_small")
    assert ref["f32"]["x_id"] == 1.0
    assert ref["f32"]["edgeconv_launches_by_route"] == {"tc": 0, "fma": 0}
    oracle = chip_smoke.phase_oracle(dev, batch=8, npoint=64)
    assert oracle["max_rot_err_deg"] < 3.0
    fold = chip_smoke.phase_fold_cost(dev, iters=2)
    assert fold == {"fused_args_kept_ms": None, "fused_args_refold_ms": None}
    assert serving["kernel_launches_per_batch"] is None and serving["device_ms_per_batch"] is None
    tc, fma = chip_smoke.kernel_summary(rows, {"tc": 0, "fma": 0})
    for entry in (tc, fma):
        for key in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms"):
            assert key in entry
        assert (ROOT / entry["source"]).exists()
        assert entry["ms"] is None and entry["plain_ms"] is None   # no time off the card
    assert tc["source"] != fma["source"] and tc["name"] != fma["name"]
    assert tc["bound_by"] == "bytes"             # bf16: x and out over the HBM rate
    # f32 at the main path's size: the projections over the FMA rate
    assert chip_smoke.edgeconv_bound_ms(512, 512, 20, 256, 256, torch.float32)[1] == "operations"
    if not torch.cuda.is_available():
        assert chip_smoke.main([]) == 1          # the script refuses the CPU


def test_chip_smoke_train_phase_rehearsed_on_cpu(tmp_path):
    """phase_train at tiny size on the CPU: every gate runs (the steps
    train, "card" against CPU, the refold after training, the loop with its
    checkpoints and the restore), no device number is made up, and the hooked
    profile of one step sees every layer type."""
    dev = torch.device("cpu")
    res = chip_smoke.phase_train(dev, batch=2, npoint=NPT, backbone="hrnet_w18_small", knn_k=5,
                                 steps_n=6, loop_steps=4, timed_steps=1,
                                 profile_dir=tmp_path / "prof", ckpt_dir=tmp_path / "train")
    first, last = res["train_loss_first5_last5"]
    assert last < first
    first, last = res["pretrain_loss_first5_last5"]
    assert last < first
    after = res["eval_after_training"]
    assert after["refolds"] == [1] * chip_smoke.EDGECONV_PER_FORWARD
    assert after["edgeconv_launches_by_route"] == {"tc": 0, "fma": 0}     # no card, no launch
    assert after["ids_agree_with_plain"] == {"x_id": 1.0, "y_id": 1.0}
    assert res["card_vs_cpu"]["loss_rel_err"] < 1e-6
    assert res["card_vs_cpu"]["grad_rel_l2_card32_vs_cpu32"] < 1e-4      # the CPU against itself
    assert 0 < res["card_vs_cpu"]["grad_rel_l2_cpu32_vs_cpu64"] < 0.1
    assert res["loop"]["kept"] == [8, 9, 10] and len(res["loop"]["best"]) == 1
    assert res["loop"]["max_param_diff_after_two_steps"] < 1e-5
    for key in ("step_ms", "steps_per_s", "peak_mem_gib", "kernel_launches_per_step",
                "device_ms_per_step", "edgeconv_train_device_ms_per_step"):
        assert res[key] is None                  # no time, rate or memory off the card
    assert sorted(res["profile"]["by_layer"]) == ["Adam", "BatchNorm", "Conv2d",
                                                  "ConvTranspose2d", "EdgeConv"]
    assert (tmp_path / "prof" / "train_profile.txt").exists()
    tc, _ = chip_smoke.kernel_summary(
        chip_smoke.phase_kernels(dev, B=1, N=32, K=4, widths=(64, 256), iters=1, plain_iters=1),
        {"tc": 55, "fma": 11}, after["edgeconv_launches_by_route"])
    assert tc["launches"] == 55 and tc["launches_by_path"] == {"serving": 55, "train_eval": 0}


def test_chip_smoke_eval_phase_rehearsed_on_cpu(tmp_path, monkeypatch):
    """phase_eval at tiny size on the CPU with cv2 and PIL unimportable: the
    port's fixture, the test CLI hard and adaptive with every gate, and no
    device number made up off the card."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    res = chip_smoke.phase_eval(
        torch.device("cpu"), root=tmp_path, n_test=3, n_calib=2, batch=4, n_vertices=64,
        cfg_overrides=dict(init_network_backbone_name="hrnet_w18_small", num_p3d_log2=4,
                           network_graph_k=5, init_network_graph_k=5),
        metric_poses=6, metric_points=300, ref_images=2)
    assert res["cv2_importable"] is False and res["fixture"]["test_images"] == 6
    hard, adaptive = res["hard"], res["adaptive"]
    assert hard["forward_batches"] == 2 and adaptive["forward_batches"] == 2 + 5
    assert hard["edgeconv_launches_by_route"] == {"tc": 0, "fma": 0}    # no card, no launch
    assert adaptive["tau"] in adaptive["tau_sweep"]
    assert res["card_vs_cpu"]["diff"] == {"seg_acc": 0.0, "seg_iou": 0.0, "bit_err": 0.0,
                                          "n_valid_mean_rel": 0.0}     # the CPU against itself
    assert res["metrics_vs_f64"]["gt_pose_max"]["add"] == 0.0
    assert res["fixture_s"] is None and res["host_crop_ms_per_image"] is None
    assert res["batch_launches"] is None and res["batch_device_ms"] is None
    assert sorted(res["warm_batch_ms"]) == ["aggregate", "forward_decode", "solver_metrics"]
    assert set(res["warm_batch_ms"].values()) == {None}
    assert hard["images_per_s"] is None and hard["images_per_s_after_first"] is None
    assert hard["peak_mem_gib"] is None and hard["cli_wall_s"] is None
    for key in ("ms_per_batch", "ms_first_batch", "ms_per_batch_after_first"):
        assert sorted(hard[key]) == ["aggregate", "forward_decode", "loader", "solver_metrics"]
        assert set(hard[key].values()) == {None}
    assert (tmp_path / "out" / "hr18GNN2_res6_gnn3Skip_mlpQuery_synth_obj01.csv").exists()
    eval_rows = res.pop("kernel_rows")          # held at the eval batch, N and K
    assert {(r["B"], r["N"], r["K"]) for r in eval_rows if not r["ragged"]} == {(4, 16, 5)}
    tc, _ = chip_smoke.kernel_summary(
        chip_smoke.phase_kernels(torch.device("cpu"), B=1, N=32, K=4, widths=(64, 256),
                                 iters=1, plain_iters=1),
        {"tc": 55, "fma": 11}, {"tc": 11, "fma": 0}, {"tc": 44, "fma": 0}, eval_rows)
    assert tc["launches_by_path"] == {"serving": 55, "train_eval": 11, "eval": 44}
    assert tc["at_eval_batch"]["B"] == 4 and tc["at_eval_batch"]["ms"] is None
    json.dumps(res)                              # the phase's JSON line serialises


def test_edgeconv_bound_matches_the_issue_table():
    """B=512, N=512, K=20, bf16: C=256 moves 268 MB (80 us at 3.35 TB/s),
    C=64 moves 67 MB (20 us); both are bound by bytes."""
    ms256, by256 = chip_smoke.edgeconv_bound_ms(512, 512, 20, 256, 256, torch.bfloat16)
    ms64, by64 = chip_smoke.edgeconv_bound_ms(512, 512, 20, 64, 64, torch.bfloat16)
    assert by256 == by64 == "bytes"
    assert abs(ms256 - 0.080) < 0.002 and abs(ms64 - 0.020) < 0.001
