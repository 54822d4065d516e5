"""The port's multi-object entry points (`checkerpose_tpu_torch/cli/
{pretrain_lm,train_lm,test_lm}.py`, the LM part of `cli/common.py`) against
the JAX package's, small networks on the CPU; and a CPU rehearsal of
chip_smoke.py's lm phase.

`resolve_cfg_lm`, `load_keypoints_lm` and the stacked `attach_p3d` are
compared exactly; `build_pose_net_lm` by class, full_bits and the converted
parameter tree. `evaluate_pipeline` with the stacked (O, N, K) table runs on
a 3-object fixture written by the JAX package's generator, both harnesses
with the same weights and the deterministic stand-in solver, per object to
1e-5 (tests/test_torch_harness.py's comparison). The CLIs run 2-3
iterations each with `device="cpu"` on the port's own fixture."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from checkerpose_tpu.cli import common as jcommon
from checkerpose_tpu.cli import train_lm as jtrain_lm
from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu.eval import harness as jharness
from checkerpose_tpu_torch.cli import common, pretrain_lm, test_lm, train_lm
from checkerpose_tpu_torch.data.bop_io import scan_bop_object
from checkerpose_tpu_torch.data.dataset import CropDataset, Loader
from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
from checkerpose_tpu_torch.eval import harness as pharness
from checkerpose_tpu_torch.models.convert import flax_to_torch
from checkerpose_tpu_torch.models.graph import EdgeConv
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_harness import _assert_reports_equal
from torch_parity import (N_HYP, few_torch_threads, load_port,  # noqa: F401 (fixture)
                          random_variables, standin_solver)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

PRE_CFG = chip_smoke.LM_PRETRAIN_CFG
TRAIN_CFG = chip_smoke.LM_TRAIN_CFG
LM_CFGS = ("config/lm/hr18GNN2_res6_gnn3Skip_mlpQuery_lm.txt",
           "config/lm/hr18GNN2_res6_gnn3Skip_mlpQuery_lm_woProg.txt",
           "config/lm/hr18GNN2_res6_gnn3Skip_mlpQuery_lm_woEdgeConv.txt",
           "config/lm/init_gnn0_hrnetw18_npt512_lm.txt", TRAIN_CFG, PRE_CFG)
NPT = 16
# hrnet_w18_small, 16 keypoints, K=5, batch 4 (real 1 + lm_imgn 3 at the
# configs' ratio 0.75), 16 solver hypotheses
SMALL_PRE = dict(network_backbone_name="hrnet_w18_small", num_p3d_log2=4, network_graph_k=5,
                 batch_size=4)
SMALL_TRAIN = dict(init_network_backbone_name="hrnet_w18_small", num_p3d_log2=4,
                   network_graph_k=5, init_network_graph_k=5, network_num_graph_module=1,
                   batch_size=4, test_batch_size=4, pnp_num_hyp=16)


@pytest.mark.parametrize("path", LM_CFGS)
def test_resolve_cfg_lm_matches_jax(path, tmp_path):
    over = {"check_point_path": str(tmp_path / "ck"), "batch_size": 8, "total_iteration": None}
    assert common.resolve_cfg_lm(path, over) == jcommon.resolve_cfg_lm(path, over)
    listed = dict(over, obj_names=["ape", "cat"])
    got = common.resolve_cfg_lm(path, listed) if "synth" not in path else None
    if got is not None:
        assert got == jcommon.resolve_cfg_lm(path, listed)
        assert got["obj_ids"] == [1, 6] and got["check_point_path"].endswith("lm13")


def test_resolve_cfg_lm_datasets_root(tmp_path):
    cfg = tmp_path / "ref_lm.txt"
    cfg.write_text("datasets_root = /data/lm\nobj_names = ape, cat duck\nbatch_size = 4\n")
    got = common.resolve_cfg_lm(str(cfg))
    assert got == jcommon.resolve_cfg_lm(str(cfg))
    assert got["bop_path"] == "/data/lm" and got["dataset_name"] == "lm"
    assert got["obj_names"] == ["ape", "cat", "duck"]


@pytest.fixture(scope="module")
def jfixture(tmp_path_factory):
    """3 objects written by the JAX package's generator: 2 test images each."""
    root = str(tmp_path_factory.mktemp("lm3"))
    jax_make_synthetic_bop(root, n_objects=3, n_scenes=1, n_images=6, n_vertices=64,
                           folders=("test",))
    cfg = common.resolve_cfg_lm(TRAIN_CFG, dict(SMALL_TRAIN, bop_path=root,
                                                obj_names="obj01,obj02,obj03"))
    return root, cfg


def test_load_keypoints_lm_and_attach_p3d_match_jax(jfixture):
    _, cfg = jfixture
    table, normed, knn = common.load_keypoints_lm(cfg)
    jtable, jnormed, jknn = jcommon.load_keypoints_lm(cfg)
    assert sorted(table) == sorted(jtable) == [1, 2, 3]
    for k in table:
        np.testing.assert_array_equal(table[k], jtable[k])
    np.testing.assert_array_equal(normed, jnormed)
    np.testing.assert_array_equal(knn, jknn)
    assert knn.shape == (3, NPT, 5) and knn.dtype == np.int32
    batch = {"image": np.zeros((3, 2, 2, 3)), "obj_idx": np.array([2, 0, 2], np.int32)}
    got = common.attach_p3d(dict(batch), normed)["p3d_normed"]
    np.testing.assert_array_equal(got, jcommon.attach_p3d(dict(batch), jnormed)["p3d_normed"])
    np.testing.assert_array_equal(got[1], normed[0])
    single = common.attach_p3d(dict(batch), normed[1])["p3d_normed"]
    assert single.shape == (3, NPT, 3) and (single == normed[1]).all()


@pytest.mark.parametrize("path", LM_CFGS[:3] + (TRAIN_CFG,))
def test_build_pose_net_lm_matches_jax(path):
    """The same class and full_bits, the parameter tree of JAX's module
    (converted) key for key and shape for shape, its graph slopes."""
    cfg = common.resolve_cfg_lm(path, {"init_network_backbone_name": "hrnet_w18_small"})
    net, full_bits = train_lm.build_pose_net_lm(cfg, NPT)
    fnet, jfull = jtrain_lm.build_pose_net_lm(cfg, NPT)
    assert type(net).__name__ == type(fnet).__name__ and full_bits == jfull
    assert full_bits == path.endswith("_woProg.txt")
    train = bool(getattr(fnet, "aux_refine_heads", False))   # the aux heads exist in train mode
    kw = {} if full_bits else {"p3d_normed": jnp.zeros((1, NPT, 3))}
    shapes = jax.eval_shape(lambda k: fnet.init(k, jnp.zeros((1, 256, 256, 3)),
                                                jnp.zeros((NPT, 5), jnp.int32), stage=3,
                                                train=train, **kw), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flax_to_torch(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == want
    convs = [m for m in net.modules() if isinstance(m, EdgeConv)]
    assert len(convs) == fnet.init_num_graph_module + 3 * fnet.num_graph_module
    assert net.res_log2 == fnet.res_log2 and net.output_res_log2(1) == fnet.output_res_log2(1)


def test_evaluate_pipeline_stacked_table_matches_jax(jfixture, monkeypatch):
    """Per object, with the whole (O, N, K) table and each sample's obj_idx:
    the JAX harness's report (bit errors, seg metrics, n_valid, rates,
    poses) to 1e-5; and evaluate_init over the same batches."""
    from checkerpose_tpu.models import InitNet as FlaxInitNet
    from checkerpose_tpu_torch.models.init_net import InitNet
    root, cfg = jfixture
    monkeypatch.setattr(jharness, "solve_poses_batched", standin_solver)
    monkeypatch.setattr(pharness, "solve_poses_batched", standin_solver)
    table, normed, knn = common.load_keypoints_lm(cfg)
    net, _ = train_lm.build_pose_net_lm(cfg, NPT, dtype=torch.float32)
    fnet = jtrain_lm.build_pose_net_lm(cfg, NPT)[0].clone(dtype=jnp.float32)
    # train=True: the config's aux refine heads exist only in a train-mode init
    variables = random_variables(fnet, jnp.zeros((1, 256, 256, 3)), knn[0],
                                 jnp.zeros((1, NPT, 3)), stage=3, train=True,
                                 bn_scale=(0.3, 0.6))
    load_port(net, variables)
    finit = FlaxInitNet(npoint=NPT, res_log2=3, backbone_name="hrnet_w18_small",
                        num_graph_module=1, dtype=jnp.float32)
    ivars = random_variables(finit, jnp.zeros((1, 256, 256, 3)), knn[0], False,
                             bn_scale=(0.3, 0.6))
    init = load_port(InitNet(npoint=NPT, res_log2=3, backbone_name="hrnet_w18_small",
                             num_graph_module=1, dtype=torch.float32), ivars)
    diameters = common.load_models_info(root, "synth")
    for obj_id in (1, 2, 3):
        ds = CropDataset(scan_bop_object(root, "synth", "test", obj_id), table, is_train=False,
                         crop_size_gt=64)
        batches = list(common.with_p3d(Loader(ds, 3, shuffle=False, drop_last=False), normed))
        assert all((b["obj_idx"] == obj_id - 1).all() for b in batches)
        kw = dict(stage=3, num_hyp=N_HYP, filter_modes=("visib",), main_filter="visib",
                  decode_mode="adaptive", decode_conf_tau=1.0)
        diameter = float(diameters[obj_id]["diameter"])
        ref = jharness.evaluate_pipeline(fnet, knn, variables, batches, table[obj_id],
                                         diameter, **kw)
        got = pharness.evaluate_pipeline(net, knn, batches, table[obj_id], diameter, **kw)
        assert got["n_images"] == 2
        _assert_reports_equal(ref, got)
        ref = jharness.evaluate_init(finit, knn, ivars, [dict(b) for b in batches], 64)
        _assert_reports_equal(ref, pharness.evaluate_init(init, knn, batches, 64))


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (pretrain_lm.main, train_lm.main, test_lm.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main({})                             # before it reads any file
    args = pretrain_lm.parse_args(["--cfg", PRE_CFG])
    assert args.device == "cuda"
    cfg = test_lm.cfg_from_args(test_lm.parse_args(
        ["--cfg", TRAIN_CFG, "--decode_mode", "adaptive", "--adx_type", "visib",
         "--device", "cpu"]))
    assert cfg["device"] == "cpu" and cfg["decode_tau_auto"] and cfg["adx_type"] == "visib"
    cfg = train_lm.cfg_from_args(train_lm.parse_args(["--cfg", TRAIN_CFG, "--device", "cpu",
                                                      "--total_iteration", "7"]))
    assert cfg["total_iteration"] == 7 and cfg["check_point_path"].endswith(
        os.path.join("hr18GNN2_res6_gnn3Skip_mlpQuery_synthlm", "lm13"))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The port's own fixture: 2 objects, 4 test and 4 train_real images, an
    lm_imgn tree of 2 renders an object and 2 backgrounds (chip_smoke's
    helper, the port's PNG codec)."""
    root = tmp_path_factory.mktemp("cli_lm")
    ds_dir = make_synthetic_bop(str(root / "data"), n_objects=2, n_scenes=1,
                                folders={"test": 4, "train_real": 4}, n_vertices=64,
                                raw_cache=True, write_png=False)
    imgn, bg = chip_smoke.make_lm_imgn_tree(ds_dir, root / "lm_imgn", ["obj01", "obj02"], 2)
    return root, imgn, bg


def test_pretrain_train_test_lm_on_the_cpu(fixture_root, capsys):
    """pretrain_lm (2 iterations) -> train_lm from its init net (2) ->
    resumed (to 3) -> test_lm hard and adaptive, all with device cpu, the
    lm_imgn renders mixed in and the background swap on."""
    root, imgn, bg = fixture_root
    data = str(root / "data")
    over = dict(bop_path=data, obj_names="obj01,obj02", tensorboard_path=str(root / "tb"),
                total_iteration=2, test_freq=2, log_freq=1, device="cpu",
                training_data_folder_2="lm_imgn", lm_imgn_root=imgn, background_root=bg,
                change_bg_prob=0.5)
    pcfg = common.resolve_cfg_lm(PRE_CFG, dict(SMALL_PRE, **over,
                                               check_point_path=str(root / "pre")))
    pcfg.pop("backbone_pretrain_checkpoint")
    st = pretrain_lm.main(pcfg)
    out = capsys.readouterr().out
    pre_dir = root / "pre" / os.path.splitext(os.path.basename(PRE_CFG))[0] / "lm13"
    assert pcfg["check_point_path"] == str(pre_dir) and st.step == 2
    assert (pre_dir / "2" / "state.pt").is_file() and "eval @ 2: test_acc=" in out

    tcfg = common.resolve_cfg_lm(TRAIN_CFG, dict(
        SMALL_TRAIN, **over, check_point_path=str(root / "train"),
        init_pretrained_root=str(pre_dir.parent),
        Detection_reaults=f"{data}/detection_results/synth/synth_detections.json"))
    st = train_lm.main(tcfg)
    out = capsys.readouterr().out
    assert f"loaded pretrained init net from {pre_dir} (step 2)" in out
    assert "per-object adx10: {'obj01'" in out and "gate[one_minus_mean_bit_err]" in out
    assert st.step == 2 and CheckpointManager(tcfg["check_point_path"]).best_floor(
        "one_minus_mean_bit_err") == st.best_score
    st = train_lm.main(dict(tcfg, load_checkpoint=True, total_iteration=3))
    assert "resumed from step 2" in capsys.readouterr().out and st.step == 3

    qcfg = dict(tcfg, ckpt_dir=tcfg["check_point_path"], eval_output_path=str(root / "out"),
                adx_type="visib")
    per_obj, avg = test_lm.main(dict(qcfg, decode_mode="hard"))
    assert sorted(per_obj) == ["obj01", "obj02"] and 0.0 <= avg["adx10"] <= 1.0
    per_obj, _ = test_lm.main(dict(qcfg, decode_mode="adaptive", decode_tau_auto=True))
    out = capsys.readouterr().out
    assert "auto-calibrated decode_conf_tau=" in out
    import json
    with open(root / "out" / f"report_lm_{tcfg['config_file_name']}.json") as f:
        rep = json.load(f)
    assert sorted(rep) == ["average", "bit_err", "bit_err_per_object", "decode_conf_tau",
                           "decode_mode", "per_object", "tau_sweep"]
    assert rep["decode_conf_tau"] in pharness.DEFAULT_TAU_GRID
    assert len(rep["bit_err"]) == 13 and sorted(rep["bit_err_per_object"]) == ["obj01", "obj02"]


def test_chip_smoke_lm_phase_rehearsed_on_cpu(tmp_path):
    """phase_lm at tiny size on the CPU: every gate runs, the LM paths launch
    no kernel and take the per-sample path once per EdgeConv and forward
    batch, and no device number is made up."""
    res = chip_smoke.phase_lm(
        torch.device("cpu"), root=tmp_path, n_objects=2, n_test=4, n_train=4, n_scenes=1,
        n_imgn=2, batch=4, n_vertices=64, iters=2, test_freq=2, resume_to=3, woprog_iters=1,
        log_freq=1, cfg_overrides=SMALL_TRAIN, pretrain_overrides=SMALL_PRE)
    assert res["fixture"]["seconds"] is None and res["fixture"]["imgn_renders"] == 4
    pre, tr = res["pretrain_lm"], res["train_lm"]
    assert pre["checkpoints"] == [2] and pre["evals"] == 1
    assert tr["resumed_to"] == 3 and len(tr["gate_scores"]) == 1
    assert tr["init_entries_grafted"] > 0 and tr["most_objects_in_a_batch"] == 2
    assert tr["background_swaps"]["syn"] > 0
    for path, by_route in res["launches_by_path"].items():
        assert by_route["tc"] == by_route["fma"] == 0 and by_route["per_sample"] > 0, path
    # 2 objects x 1 forward batch x the EdgeConvs of each network
    assert res["launches_by_path"]["lm_pretrain"]["per_sample"] == 2 * 2
    assert res["launches_by_path"]["lm_train"]["per_sample"] == 2 * 5
    for key in ("eval_fn_s", "ms_per_iter", "peak_mem_gib"):
        assert pre[key] is None and tr[key] is None
    assert res["test_lm"]["adaptive"]["decode_conf_tau"] in pharness.DEFAULT_TAU_GRID
    assert res["paths"]["objects"] == [0, 1] and sorted(
        k for k in res["paths"] if k != "objects") == [64, 256]
    assert max(res["woprog"]["max_ids"]) < 64
    assert all(v is None for k, v in res["edgeconv_profile"].items()
               if k.endswith("_ms")) and res["edgeconv_profile"]["edgeconvs"] == 5
    assert res["card_vs_cpu"]["loss_rel_err"] == 0.0
