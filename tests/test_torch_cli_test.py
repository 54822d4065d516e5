"""The port's test CLI (`checkerpose_tpu_torch.cli.test`) against the JAX
package's, small network on the CPU.

Both CLIs read one fixture (written by the JAX package's generator, with its
frame cache) and the same weights: a JAX orbax checkpoint and the port's
`torch.save` one, converted by models/convert.py. Both build their network in
f32 (the CLIs' own `build_pose_net`, with the dtype swapped), both harnesses solve
through one deterministic stand-in (tests/torch_parity.py::standin_solver), and the
JAX crop resizes with the port's numpy resize, so the two forwards see the
same pixels (the resize itself is held against cv2 in test_torch_data.py).
Then the CSV rows, the report and the score lines are compared."""
import csv
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from checkerpose_tpu.cli import common as jcommon, test as jtest
from checkerpose_tpu.data.synthetic import make_synthetic_bop as jax_make_synthetic_bop
from checkerpose_tpu.eval import harness as jharness
from checkerpose_tpu.ops import crop as jcrop
from checkerpose_tpu.train import checkpoint as jckpt, state as jstate
from checkerpose_tpu_torch.cli import common as pcommon, test as ptest
from checkerpose_tpu_torch.eval import harness as pharness
from checkerpose_tpu_torch.ops import crop as pcrop
from checkerpose_tpu_torch.train import checkpoint as pckpt, state as pstate
from torch_parity import (few_torch_threads, load_port,  # noqa: F401 (fixture)
                          random_variables, standin_solver)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG_FILE = "config/synth/hr18GNN2_res6_gnn3Skip_mlpQuery_synth.txt"
SMALL = dict(init_network_backbone_name="hrnet_w18_small", network_num_graph_module=1,
             init_network_num_graph_module=1, num_p3d_log2=4, network_graph_k=5,
             init_network_graph_k=5, aux_refine_heatmap_weight=0.0, test_batch_size=3,
             pnp_num_hyp=16, decode_mode="hard")


def _cfgs(root, tmp):
    over = dict(SMALL, bop_path=root,
                Detection_reaults=f"{root}/detection_results/synth/synth_detections.json")
    j = jcommon.resolve_cfg(CFG_FILE, "obj01", dict(over, ckpt_dir=f"{tmp}/jax_ckpt",
                                                    eval_output_path=f"{tmp}/jax_out"))
    p = pcommon.resolve_cfg(CFG_FILE, "obj01", dict(over, ckpt_dir=f"{tmp}/port_ckpt",
                                                    eval_output_path=f"{tmp}/port_out",
                                                    device="cpu"))
    return j, p


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "data")
    jax_make_synthetic_bop(root, n_objects=1, n_scenes=1, n_images=5, n_vertices=64,
                           folders=("test",), raw_cache=True)
    jcfg, pcfg = _cfgs(root, tmp)
    fnet = jtest.build_pose_net(jcfg, 16).clone(dtype=jnp.float32)
    _, _, knn = jcommon.load_keypoints(jcfg)
    variables = random_variables(fnet, jnp.zeros((1, 256, 256, 3)), knn,
                                 jnp.zeros((1, 16, 3)), stage=3, train=False,
                                 bn_scale=(0.3, 0.6))
    # the RoI bit's bias up, so keypoints are in the RoI and the solver runs
    variables["params"]["init_net"]["mlp"]["bias"][0] += 4.0
    mgr = jckpt.CheckpointManager(jcfg["ckpt_dir"])
    mgr.save_best(jstate.TrainState(params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=optax.adam(1e-4).init(variables["params"]),
                                    step=7, best_score=0.25))
    mgr.wait()
    net = load_port(ptest.build_pose_net(pcfg, 16, dtype=torch.float32), variables)
    pckpt.CheckpointManager(pcfg["ckpt_dir"]).save_best(
        pstate.TrainState(module=net, optimizer=pstate.make_optimizer(1e-4)(net.parameters()),
                          step=7, best_score=0.25))

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtest, "build_pose_net",
                   lambda cfg, n, orig=jtest.build_pose_net: orig(cfg, n).clone(dtype=jnp.float32))
        mp.setattr(ptest, "build_pose_net",
                   lambda cfg, n, orig=ptest.build_pose_net: orig(cfg, n, dtype=torch.float32))
        mp.setattr(jharness, "solve_poses_batched", standin_solver)
        mp.setattr(pharness, "solve_poses_batched", standin_solver)
        mp.setattr(jcrop, "_resize_np", pcrop._resize_np)
        reports = (jtest.main(jcfg), ptest.main(pcfg))
    finally:
        mp.undo()
    return jcfg, pcfg, reports


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_csv_rows_match_jax(runs):
    jcfg, pcfg, _ = runs
    name = "hr18GNN2_res6_gnn3Skip_mlpQuery_synth_obj01.csv"
    a = _read_csv(os.path.join(jcfg["eval_output_path"], name))
    b = _read_csv(os.path.join(pcfg["eval_output_path"], name))
    assert a[0] == b[0] == ["scene_id", "im_id", "obj_id", "score", "R", "t", "time"]
    assert len(a) == len(b) > 1
    for ra, rb in zip(a[1:], b[1:]):
        assert ra[:4] == rb[:4] and ra[6] == rb[6] == "-1"
        np.testing.assert_allclose(np.array(rb[4].split(), float), np.array(ra[4].split(), float),
                                   atol=1e-5)
        np.testing.assert_allclose(np.array(rb[5].split(), float), np.array(ra[5].split(), float),
                                   rtol=1e-5, atol=1e-4)


def test_report_and_score_lines_match_jax(runs):
    jcfg, pcfg, (jrep, prep) = runs
    tag = "hr18GNN2_res6_gnn3Skip_mlpQuery_synth_obj01"
    with open(os.path.join(jcfg["eval_output_path"], f"report_{tag}.json")) as f:
        a = json.load(f)
    with open(os.path.join(pcfg["eval_output_path"], f"report_{tag}.json")) as f:
        b = json.load(f)
    assert sorted(a) == sorted(b)
    # chip_smoke's gate (a) holds the card's reports to this list
    assert sorted(jrep) == sorted(prep) == sorted(chip_smoke.EVAL_REPORT_KEYS)
    assert sorted(jrep["none"]) == sorted(chip_smoke.EVAL_MODE_KEYS)
    assert a["n_images"] == b["n_images"] == 5 and a["decode_mode"] == b["decode_mode"]
    for mode in ("none", "full", "visib"):
        for k in a[mode]:
            np.testing.assert_allclose(b[mode][k], a[mode][k], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b["bit_err"], a["bit_err"], atol=1e-6)

    def lines(cfg):
        with open(os.path.join(cfg["eval_output_path"], f"score_{tag}.txt")) as f:
            return [ln.split() for ln in f]

    la, lb = lines(jcfg), lines(pcfg)
    assert len(la) == len(lb) == 5              # 3 filter modes, seg, test_acc
    for wa, wb in zip(la, lb):
        assert [w.split("=")[0] for w in wa] == [w.split("=")[0] for w in wb]
        for x, y in zip(wa, wb):
            if "=" in x:
                np.testing.assert_allclose(float(y.split("=")[1]), float(x.split("=")[1]),
                                           atol=1e-4, err_msg=x)     # nan equals nan


def test_csv_writer_and_merge_match_jax(tmp_path):
    """write_csv and merge_csv write the same bytes as the JAX package's."""
    from checkerpose_tpu.eval import csv_writer as jcsv
    from checkerpose_tpu_torch.eval import csv_writer as pcsv
    rng = np.random.default_rng(0)
    Rs, ts = rng.standard_normal((4, 3, 3)).astype(np.float32), rng.standard_normal((4, 3))
    rows = ([0, 0, 1, 1], [0, 3, 1, 2], Rs, ts, [1.0, -1.0, 1.0, 1.0])
    for name, mod in (("j", jcsv), ("p", pcsv)):
        paths = [mod.write_csv(str(tmp_path / name), f"obj{o}", o, *rows) for o in (1, 5)]
        mod.merge_csv(paths, str(tmp_path / f"{name}_all.csv"))
    for rel in ("obj1.csv", "obj5.csv"):
        assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
    assert (tmp_path / "p_all.csv").read_bytes() == (tmp_path / "j_all.csv").read_bytes()
    assert len((tmp_path / "p_all.csv").read_text().splitlines()) == 1 + 2 * 3


def test_flags_match_jax(monkeypatch):
    argv = ["--cfg", CFG_FILE, "--obj_name", "obj01", "--ckpt_dir", "/c", "--use_latest",
            "--decode_mode", "adaptive", "--test_batch_size", "8", "--use_progressivex",
            "--reprojErr_thresh", "3.5", "--filter_judge_bits", "3"]
    monkeypatch.setattr(sys, "argv", ["test.py", *argv])
    ref = vars(jtest.parse_args())
    got = vars(ptest.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == ref
    cfg = ptest.cfg_from_args(ptest.parse_args(argv + ["--device", "cpu"]))
    assert cfg["decode_tau_auto"] is True and cfg["device"] == "cpu"
    assert cfg["use_latest"] is True and cfg["ckpt_dir"] == "/c"
    assert pcommon.solver_kwargs(cfg) == jcommon.solver_kwargs(cfg)
    assert pcommon.checkpoint_dir_arg(None, CFG_FILE) == jcommon.checkpoint_dir_arg(None, CFG_FILE)


def test_cli_runs_without_an_image_codec(monkeypatch, tmp_path):
    """cv2 and PIL unimportable: the port's generator writes a frame cache,
    and the CLI evaluates a checkpoint from it on the CPU, hard and
    adaptive with the tau calibrated on train_real."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
    root = str(tmp_path / "data")
    make_synthetic_bop(root, n_objects=1, n_scenes=1, n_vertices=64,
                       folders={"test": 4, "train_real": 2})
    _, cfg = _cfgs(root, tmp_path)
    net = ptest.build_pose_net(cfg, 16)
    st = pstate.create_pose_state(net, pstate.make_optimizer(1e-4), device="cpu")
    pckpt.CheckpointManager(cfg["ckpt_dir"]).save(st)
    rep = ptest.main(dict(cfg, calib_folder="train_real", decode_mode="adaptive",
                          decode_tau_auto=True))
    assert rep["n_images"] == 4 and sorted(rep["tau_sweep"]) == [3.0, 4.0, 5.0, 6.0, 8.0]
    assert os.path.isfile(os.path.join(cfg["eval_output_path"],
                                       "hr18GNN2_res6_gnn3Skip_mlpQuery_synth_obj01.csv"))
