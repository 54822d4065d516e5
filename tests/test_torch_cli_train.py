"""The port's training entry points (`checkerpose_tpu_torch/cli/pretrain.py`,
`cli/train.py`) and the pretrained-backbone graft (`cli/common.py`,
`models/convert.py`) against the JAX package's, small networks on the CPU;
and a CPU rehearsal of chip_smoke.py's workflow phase.

The graft is compared leaf by leaf on Flax trees converted with
models/convert.py (exact). The train CLI's per-run decisions (stage schedule,
teacher forcing annealed at the resume step, the prefix-correct mask, the
fine-bit weights, the best-checkpoint gate) are held against the JAX
package's functions over a grid of steps and configs (exact). The CLIs run a
few iterations each on the port's own fixture with the init-net handoff, a
resume and the backbone graft."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from checkerpose_tpu import config as jconfig
from checkerpose_tpu.cli import train as jtrain
from checkerpose_tpu.models.convert import graft_backbone as jgraft
from checkerpose_tpu.train import steps as jsteps
from checkerpose_tpu_torch.cli import common, pretrain, train
from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
from checkerpose_tpu_torch.models.convert import flax_to_torch, graft_backbone
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.state import create_init_state, make_optimizer
from torch_parity import few_torch_threads, random_variables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

PRETRAIN_CFG = chip_smoke.PRETRAIN_CFG
TRAIN_CFG = chip_smoke.EVAL_CFG
NPT = 16
# hrnet_w18_small, 16 keypoints, K=5, one graph module, batch 4
SMALL_PRE = dict(network_backbone_name="hrnet_w18_small", num_p3d_log2=4, network_graph_k=5,
                 batch_size=4, device="cpu")
SMALL_TRAIN = dict(init_network_backbone_name="hrnet_w18_small", num_p3d_log2=4,
                   network_graph_k=5, init_network_graph_k=5, network_num_graph_module=1,
                   batch_size=4, test_batch_size=4, device="cpu")


# --- graft_backbone ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pose_trees():
    """Two PoseNets' Flax variables (hrnet_w18_small, 16 keypoints) from
    different seeds: the target and, in its init net's backbone, the source."""
    cfg = common.resolve_cfg(TRAIN_CFG, "obj01", SMALL_TRAIN)
    fnet = jtrain.build_pose_net(cfg, NPT).clone(dtype=jnp.float32)
    args = (jnp.zeros((1, 256, 256, 3)), jnp.zeros((NPT, 5), jnp.int32),
            jnp.zeros((1, NPT, 3)))
    return [random_variables(fnet, *args, stage=3, train=False, seed=s) for s in (0, 1)]


def _with_first_leaf(tree, fn):
    """A copy of a nested dict with its first leaf replaced by fn(leaf)."""
    k = next(iter(tree))
    v = tree[k]
    return {**tree, k: _with_first_leaf(v, fn) if isinstance(v, dict) else fn(v)}


def _backbone(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_graft_backbone_matches_jax(pose_trees):
    """Into a PoseNet's init net: the converted JAX graft equals the port's
    graft of the converted trees, entry for entry; every backbone entry
    comes from the source, every other one from the target."""
    target, source = pose_trees
    new_p, new_s = jgraft(target["params"], target["batch_stats"],
                          source["params"]["init_net"]["backbone"],
                          source["batch_stats"]["init_net"]["backbone"])
    want = flax_to_torch({"params": new_p, "batch_stats": new_s})
    sd_t, sd_s = flax_to_torch(target), flax_to_torch(source)
    got = graft_backbone(sd_t, _backbone(sd_s, "init_net.backbone."))
    assert sorted(got) == sorted(want) == sorted(sd_t)
    n_bb = 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        from_source = k.startswith("init_net.backbone.")
        n_bb += from_source
        assert torch.equal(got[k], (sd_s if from_source else sd_t)[k]), k
    assert n_bb > 100


def test_graft_backbone_into_an_init_net_and_errors(pose_trees):
    """into="" grafts an InitNet's own state_dict and casts to its dtype;
    an unknown key raises KeyError and a wrong shape ValueError, as in JAX."""
    target, source = pose_trees
    sd_s = flax_to_torch(source)
    bb = _backbone(sd_s, "init_net.backbone.")
    net = InitNet(NPT, backbone_name="hrnet_w18_small", dtype=torch.bfloat16)
    own = net.state_dict()
    got = graft_backbone(own, bb, into="")
    for k, v in own.items():
        if k.startswith("backbone."):
            assert got[k].dtype == v.dtype
            assert torch.equal(got[k], bb[k[len("backbone."):]].to(v.dtype)), k
        else:
            assert got[k] is v
    net.load_state_dict(got)

    tp, ts = target["params"], target["batch_stats"]
    sp = dict(source["params"]["init_net"]["backbone"])
    sp["no_such_layer"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(KeyError):
        jgraft(tp, ts, sp, source["batch_stats"]["init_net"]["backbone"])
    with pytest.raises(KeyError):
        graft_backbone(flax_to_torch(target), dict(bb, **{"no_such_layer.weight": torch.zeros(1)}))
    name = next(k for k, v in bb.items() if v.ndim == 4)
    bad = dict(bb, **{name: torch.zeros(bb[name].shape[0] + 1, *bb[name].shape[1:])})
    with pytest.raises(ValueError):
        graft_backbone(flax_to_torch(target), bad)
    sp = _with_first_leaf(source["params"]["init_net"]["backbone"],
                          lambda v: np.zeros(np.shape(v) + (1,), np.float32))
    with pytest.raises(ValueError):
        jgraft(tp, ts, sp, source["batch_stats"]["init_net"]["backbone"])


# --- the pretrained-backbone graft and the init-net handoff ------------------------------


def _init_state(seed=0):
    net = InitNet(NPT, backbone_name="hrnet_w18_small", num_graph_module=2)
    return create_init_state(net, make_optimizer(1e-4), seed=seed, device="cpu")


def test_maybe_graft_pretrained_backbone(tmp_path, monkeypatch, capsys):
    """Fires at step 0 only; a dir with no numbered step warns (or raises
    under CHECKERPOSE_REQUIRE_BACKBONE_GRAFT=1) and is not created."""
    src = _init_state(seed=1)
    src.step = 7
    CheckpointManager(str(tmp_path / "src")).save(src)
    st = _init_state(seed=0)
    own = {k: v.clone() for k, v in st.module.state_dict().items()}
    cfg = {"backbone_pretrain_checkpoint": str(tmp_path / "src")}
    out = common.maybe_graft_pretrained_backbone(cfg, st)
    assert f"grafted NOCS-pretrained backbone from {tmp_path / 'src'} (step 7)" \
        in capsys.readouterr().out
    assert out.step == 0 and out.module is st.module and out.optimizer is st.optimizer
    sd_src, sd = src.module.state_dict(), out.module.state_dict()
    differ = 0
    for k, v in sd.items():
        assert torch.equal(v, (sd_src if k.startswith("backbone.") else own)[k]), k
        differ += not torch.equal(own[k], sd_src[k])
    assert differ > 50           # the conv kernels: seeds differ, zero biases do not

    later = _init_state(seed=0)
    later.step = 5
    before = {k: v.clone() for k, v in later.module.state_dict().items()}
    assert common.maybe_graft_pretrained_backbone(cfg, later) is later
    assert all(torch.equal(v, before[k]) for k, v in later.module.state_dict().items())
    assert common.maybe_graft_pretrained_backbone({}, st) is st

    missing = {"backbone_pretrain_checkpoint": str(tmp_path / "typo")}
    assert common.maybe_graft_pretrained_backbone(missing, st) is st
    assert "training the backbone from scratch" in capsys.readouterr().out
    assert not (tmp_path / "typo").exists()
    monkeypatch.setenv("CHECKERPOSE_REQUIRE_BACKBONE_GRAFT", "1")
    with pytest.raises(FileNotFoundError, match="CHECKERPOSE_REQUIRE_BACKBONE_GRAFT"):
        common.maybe_graft_pretrained_backbone(missing, st)
    (tmp_path / "empty" / "3").mkdir(parents=True)     # a step dir with no state file
    with pytest.raises(FileNotFoundError, match="no restorable step"):
        common.maybe_graft_pretrained_backbone(
            {"backbone_pretrain_checkpoint": str(tmp_path / "empty")}, st)


def test_load_pretrained_init_latest_best_missing(tmp_path, capsys):
    """The latest checkpoint under <root>/<obj_name>, else the best one;
    None with a message when neither exists or the dir is missing."""
    cfg = dict(init_pretrained_root=str(tmp_path), obj_name="obj01", num_p3d_log2=4,
               init_network_backbone_name="hrnet_w18_small")
    mgr = CheckpointManager(str(tmp_path / "obj01"))
    states = {}
    for step, seed in ((4, 1), (9, 2)):
        st = _init_state(seed)
        st.step = step
        mgr.save(st)
        states[step] = {k: v.clone() for k, v in st.module.state_dict().items()}
    st = _init_state(3)
    st.step = 6
    mgr.save_best(st)
    states["best"] = {k: v.clone() for k, v in st.module.state_dict().items()}

    got = train.load_pretrained_init(cfg)
    assert "(step 9)" in capsys.readouterr().out
    assert sorted(got) == sorted(states[9])
    assert all(torch.equal(got[k], v) for k, v in states[9].items())
    for step in (4, 9):
        shutil.rmtree(tmp_path / "obj01" / str(step))
    got = train.load_pretrained_init(cfg)
    assert "(step 6)" in capsys.readouterr().out
    assert all(torch.equal(got[k], v) for k, v in states["best"].items())
    shutil.rmtree(tmp_path / "obj01" / "best")
    assert train.load_pretrained_init(cfg) is None
    assert "no init checkpoint" in capsys.readouterr().out
    assert train.load_pretrained_init(dict(cfg, obj_name="obj02")) is None
    assert "missing; training from scratch" in capsys.readouterr().out
    assert train.load_pretrained_init(dict(cfg, init_pretrained_root=None)) is None


# --- the train CLI's per-run decisions ---------------------------------------------------

DECISION_CFGS = [
    {},
    {"stage_start_steps_str": "0_100_250", "refine_teacher_force_prob": 0.5,
     "refine_teacher_force_anneal_start": 100, "refine_teacher_force_anneal_end": 300},
    {"stage_start_steps_str": "50_100_250", "prefix_correct_finebit_mask": True,
     "prefix_correct_start_step": 200, "finebit_loss_boost_weight": 3.0,
     "refine_teacher_force_anneal_end": 150},
    {"stage_start_steps_str": "0_0_0", "finebit_loss_boost_weight": 2.0,
     "finebit_boost_start_bit": 5, "finebit_boost_start_step": 120,
     "prefix_correct_finebit_mask": True, "refine_teacher_force_prob": 0.25,
     "refine_teacher_force_anneal_start": 0, "refine_teacher_force_anneal_end": 40,
     "RoiBit_Loss_Type": "L1", "coord_reg_loss_weight": 0.25},
]
STEPS = (0, 39, 49, 50, 99, 100, 120, 150, 199, 200, 250, 299, 300, 1000)


@pytest.mark.parametrize("ci", range(len(DECISION_CFGS)))
def test_per_run_decisions_match_jax(ci, capsys):
    """For every resume step: the stage of every step, the teacher-forcing
    probability, the prefix-correct mask and the fine-bit weights per stage
    equal what the JAX CLI computes with its own functions."""
    cfg = DECISION_CFGS[ci]
    n = 3
    starts = train.stage_starts(cfg, n)
    want_starts = jconfig.stage_start_steps(cfg) or (0,) * n
    assert tuple(starts) == tuple(want_starts)
    assert ("WARNING: stage_start_steps" in capsys.readouterr().out) == (want_starts[0] > 0)
    for step in STEPS:
        opts = train.step_options(cfg, step, n)
        said = capsys.readouterr().out
        tf_base = float(cfg.get("refine_teacher_force_prob", 0.0))
        tf = jsteps.teacher_force_prob_at(
            step, tf_base,
            int(cfg.get("refine_teacher_force_anneal_start", 0)),
            int(cfg.get("refine_teacher_force_anneal_end", 0)))
        prefix = (bool(cfg.get("prefix_correct_finebit_mask", False))
                  and step >= int(cfg.get("prefix_correct_start_step", 0)))
        assert ("teacher forcing annealed" in said) == (tf != tf_base)
        assert ("prefix-correct fine-bit masking ON" in said) == prefix
        assert sorted(opts) == [1, 2, 3]
        for stage, kw in opts.items():
            assert kw["teacher_force_prob"] == tf
            assert kw["prefix_correct_mask"] == prefix
            assert kw["bit_weights"] == jsteps.finebit_bit_weights(cfg, step, 3 + stage)
            assert kw["roi_loss_type"] == cfg.get("RoiBit_Loss_Type", "BCE")
            assert kw["coord_reg_weight"] == float(cfg.get("coord_reg_loss_weight", 0.0))
        for s in STEPS:
            assert max(1, jconfig.get_train_stage(s, want_starts)) == \
                max(1, train.get_train_stage(s, starts))


def test_gate_and_args():
    rep = train.gated({"bit_err": [0.0, 0.25, 0.5], "test_acc": 0.1})
    assert rep["gate_score"] == 1.0 - 0.25 and rep["gate_metric"] == "one_minus_mean_bit_err"
    assert "gate_score" not in train.gated({"test_acc": 0.1})
    for mod in (pretrain, train):
        a = mod.parse_args(["--cfg", TRAIN_CFG, "--obj_name", "obj01"])
        assert a.device == "cuda" and not a.load_checkpoint
        cfg = mod.cfg_from_args(mod.parse_args(["--cfg", TRAIN_CFG, "--obj_name", "obj01",
                                                "--device", "cpu", "--total_iteration", "7"]))
        assert cfg["device"] == "cpu" and cfg["total_iteration"] == 7
        assert "load_checkpoint" not in cfg or not cfg["load_checkpoint"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mod.main({})                             # before it reads any file


# --- the CLIs on the port's fixture ------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    make_synthetic_bop(str(root / "data"), n_objects=1, n_scenes=1,
                       folders={"test": 4, "train_real": 8}, n_vertices=64,
                       raw_cache=True, write_png=False)
    return root


def test_pretrain_then_train_with_handoff_graft_and_resume(fixture_root, capsys):
    """pretrain (3 iterations) -> pretrain again from its backbone (1) ->
    train from its init net (3) -> train resumed (to 4), all on the CPU."""
    root, data = fixture_root, str(fixture_root / "data")
    pcfg = common.resolve_cfg(PRETRAIN_CFG, "obj01", dict(
        SMALL_PRE, bop_path=data, check_point_path=str(root / "pre"),
        tensorboard_path=str(root / "tb"), total_iteration=3, test_freq=2, log_freq=1))
    pcfg.pop("backbone_pretrain_checkpoint")
    st = pretrain.main(pcfg)
    out = capsys.readouterr().out
    pre_dir = root / "pre" / os.path.splitext(os.path.basename(PRETRAIN_CFG))[0] / "obj01"
    assert pcfg["check_point_path"] == str(pre_dir)
    assert st.step == 3 and all((pre_dir / d / "state.pt").is_file() for d in ("2", "3"))
    assert "  bit_err roi=" in out and "#parameters:" in out
    assert len(os.listdir(pre_dir / "best")) == 1

    gcfg = dict(pcfg, check_point_path=str(root / "graft"), total_iteration=1,
                backbone_pretrain_checkpoint=str(pre_dir))
    pretrain.main(gcfg)
    assert f"grafted NOCS-pretrained backbone from {pre_dir} (step 3)" in capsys.readouterr().out

    tcfg = common.resolve_cfg(TRAIN_CFG, "obj01", dict(
        SMALL_TRAIN, bop_path=data, check_point_path=str(root / "train"),
        tensorboard_path=str(root / "tb"), total_iteration=3, test_freq=2, log_freq=1,
        init_pretrained_root=str(pre_dir.parent),
        Detection_reaults=f"{data}/detection_results/synth/synth_detections.json",
        refine_teacher_force_anneal_start=0, refine_teacher_force_anneal_end=10))
    st = train.main(tcfg)
    out = capsys.readouterr().out
    assert f"loaded pretrained init net from {pre_dir} (step 3)" in out
    assert "teacher forcing annealed" not in out            # step 0: the base probability
    assert st.step == 3 and "gate[one_minus_mean_bit_err]" in out
    assert CheckpointManager(tcfg["check_point_path"]).best_floor("one_minus_mean_bit_err") \
        == st.best_score
    st = train.main(dict(tcfg, load_checkpoint=True, total_iteration=4))
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and st.step == 4
    assert "teacher forcing annealed 0.5 -> 0.350 (resume step 3)" in out


# --- chip_smoke.py's workflow phase ------------------------------------------------------


def test_chip_smoke_workflow_phase_rehearsed_on_cpu(tmp_path):
    """phase_workflow at tiny size on the CPU: every gate runs, no kernel
    launches off the card, and no device number is made up."""
    res = chip_smoke.phase_workflow(
        torch.device("cpu"), root=tmp_path, n_test=3, n_train=4, batch=4, n_vertices=64,
        iters=3, test_freq=2, resume_to=4, graft_iters=1, log_freq=1,
        cfg_overrides={k: v for k, v in SMALL_TRAIN.items() if k != "device"},
        pretrain_overrides={k: v for k, v in SMALL_PRE.items() if k != "device"})
    assert res["fixture"]["depth_pngs"] == 6 and res["fixture"]["seconds"] is None
    pre, tr = res["pretrain"], res["train"]
    assert pre["checkpoints"] == [2, 3] and pre["eval_batches"] == [2, 2]
    assert tr["resumed_to"] == 4 and len(tr["gate_scores"]) == 2 and tr["evals"] == 3
    assert tr["init_entries_grafted"] > 0 and res["graft"]["entries"] > 0
    for path, by_route in res["launches_by_path"].items():
        assert by_route == {"tc": 0, "fma": 0}, path      # no card, no launch
    for key in ("eval_s", "ms_per_iter", "peak_mem_gib"):
        assert pre[key] is None and tr[key] is None
    assert tr["ms_per_iter_resumed"] is None
    gt = res["scores"]["gt"]["per_object"]
    assert gt["ar_mssd"] == gt["ar_mspd"] == 1.0 and gt["ar_vsd"] > 0.95
    for sc in res["scores"].values():
        assert sc["errors_s"] is None and sc["vsd_s"] is None and sc["vsd_renders"] > 0
    for e in res["bop_errors_vs_f64"].values():
        assert e["device_ms"] is None
    errs = res["bop_errors_vs_f64"]
    assert sorted(errs) == ["perturbed/continuous_z", "perturbed/own",
                            "test_cli/continuous_z", "test_cli/own"]
    assert errs["perturbed/continuous_z"]["syms"] == 64 and errs["perturbed/own"]["syms"] == 1
    # the perturbed poses' errors lie at the scale of the MSSD thresholds
    pert = errs["perturbed/own"]
    assert 0.01 < pert["median"]["mssd"] / pert["diameter"] < 0.5
    assert sorted(res["kernel_inputs"]) == [64, 256]
    tc, _ = chip_smoke.kernel_summary(
        chip_smoke.phase_kernels(torch.device("cpu"), B=1, N=32, K=4, widths=(64, 256),
                                 iters=1, plain_iters=1),
        {"tc": 55, "fma": 11}, {"tc": 11, "fma": 0}, {"tc": 44, "fma": 0}, None,
        {"workflow_pretrain": {"tc": 8, "fma": 0}, "workflow_train": {"tc": 44, "fma": 0}})
    assert tc["launches_by_path"] == {"serving": 55, "train_eval": 11, "eval": 44,
                                      "workflow_pretrain": 8, "workflow_train": 44}
