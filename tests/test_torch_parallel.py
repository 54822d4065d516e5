"""Data parallelism of the port (`checkerpose_tpu_torch/parallel/mesh.py`,
sync-BN in `models/layers.py`, the global normalizers of `losses/` and
`train/steps.py`, `train/loop.py`, `train/checkpoint.py`, the training CLIs)
against one process and against the JAX package, with gloo on the CPU.

The cases of tests/test_sharding.py, each held against a one-process run:
the mesh with and without torchrun's environment, `shard_batch`, a Linear's
gradient (rtol 2e-5, atol 1e-6), the PoseNet step (per leaf abs < 5e-4 or
rel < 1e-3), the solver on its rows, `make_global_batch`, `shard_manifest`.
Added: BatchNorm's global statistics, every loss at W=2, the PoseNet step with
augmentation and teacher forcing on a batch whose shards hold different
in-RoI counts (and DDP-style per-rank normalizers, which must miss the bar),
the W=2 step against JAX's step, `run_training` at W=2 and the pretrain CLI
under torchrun's environment at W=2; and a CPU rehearsal of chip_smoke.py's
parallel phase.

The ranks run in one 4-process group for the whole module (the 2-rank cases
on its subgroup {0, 1}, tests/torch_dp_ranks.py) and one 2-process group for
the CLI; each has a 60 s process-group timeout and a 60 s join."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from checkerpose_tpu.models import PoseNet as FlaxPoseNet
from checkerpose_tpu.parallel.mesh import shard_manifest as jshard_manifest
from checkerpose_tpu.train import steps as jsteps
from checkerpose_tpu_torch.cli import common
from checkerpose_tpu_torch.data.synthetic import make_synthetic_bop
from checkerpose_tpu_torch.models.convert import flax_to_torch
from checkerpose_tpu_torch.ops.geometry import pc_normalize
from checkerpose_tpu_torch.ops.knn import knn_index
from checkerpose_tpu_torch.parallel import mesh as pmesh
from checkerpose_tpu_torch.solver.ransac import solve_poses_batched
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager

import chip_smoke
import torch_dp_ranks as dp
from torch_parity import few_torch_threads, random_variables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

NPT, KNN, B = 16, 5, 4
# tests/test_sharding.py's bars
LEAF_ABS, LEAF_REL = 5e-4, 1e-3
# JAX against the port (tests/test_torch_train_steps.py's bars)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
HEAD_TOL, LEAF_L2_TOL, GLOBAL_L2_TOL = 1e-3, 0.1, 0.05
# in-RoI keypoints of the 4 rows: shards of 2 rows hold 28 and 12, of 1 row 16/12/4/8
IN_ROI = (16, 12, 4, 8)


def _uneven_batch(rng, p3dn):
    """B rows whose first IN_ROI[b] keypoints project inside the final bbox
    [50, 60, 130, 130] and the others left of it."""
    proj = np.stack([rng.uniform(60, 170, (B, NPT)), rng.uniform(70, 180, (B, NPT))], -1)
    for b, n in enumerate(IN_ROI):
        proj[b, n:, 0] = rng.uniform(5, 45, NPT - n)
    return {"image": rng.integers(0, 255, (B, 256, 256, 3)).astype(np.uint8),
            "proj_xy": proj.astype(np.float32),
            "bbox": np.tile(np.array([50, 60, 130, 130], np.float32), (B, 1)),
            "mask_visib": (rng.random((B, 64, 64)) > 0.5).astype(np.float32),
            "mask_full": (rng.random((B, 64, 64)) > 0.3).astype(np.float32),
            "p3d_normed": np.tile(p3dn[None], (B, 1, 1))}


def _loss_inputs(rng):
    G, N, L = 8, 6, 4
    mask = np.zeros((G, N, 1), np.float32)
    for b, n in enumerate((6, 5, 1, 0, 3, 6, 2, 4)):                # uneven, one row empty
        mask[b, :n] = 1.0
    R = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(G)])
    R *= np.sign(np.linalg.det(R))[:, None, None]
    t = np.stack([rng.uniform(-20, 20, G), rng.uniform(-20, 20, G), rng.uniform(300, 500, G)], 1)
    arrays = dict(
        logits=rng.standard_normal((G, N, L)), logits2=rng.standard_normal((G, N, L)),
        gt=(rng.random((G, N, L)) > 0.5), ce_gt=rng.integers(0, L, (G, N)), mask=mask,
        bit_masks=(rng.random((G, N, L)) > 0.3), seg=rng.standard_normal((G, 8, 8)),
        seg_gt=(rng.random((G, 16, 16)) > 0.5), resp=rng.standard_normal((G, N, 64)),
        x_id=rng.integers(0, 64, (G, N)), y_id=rng.integers(0, 64, (G, N)),
        x_rel=rng.uniform(0, 64, (G, N)), y_rel=rng.uniform(0, 64, (G, N)),
        nocs_out=rng.standard_normal((G, 8, 8, 4)), depth=rng.uniform(0, 500, (G, 8, 8)) *
        (rng.random((G, 8, 8)) > 0.3), mask_visib=(rng.random((G, 8, 8)) > 0.4),
        bbox=np.tile(np.array([200, 150, 64, 64.]), (G, 1)),
        cam_K=np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.]]), (G, 1, 1)),
        R=R, t=t)
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                  else v.astype(np.float32))
    return out


def _solver_inputs(rng):
    N, G = 32, 8
    p3d = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
    K = np.array([[572.4, 0, 325.2], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    p2d = []
    for _ in range(G):
        Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        Q *= np.sign(np.linalg.det(Q))
        uv = (p3d @ Q.T + np.array([0.0, 0.0, 420.0])) @ K.T
        p2d.append(uv[:, :2] / uv[:, 2:])
    return {"p3d": torch.from_numpy(p3d), "p2d": torch.tensor(np.stack(p2d), dtype=torch.float32),
            "valid": torch.ones(G, N), "K": torch.from_numpy(K), "num_hyp": 16}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The inputs, the 4 ranks' results and the one-process references."""
    rng = np.random.default_rng(0)
    p3dn = pc_normalize(rng.uniform(-30, 30, (NPT, 3))).astype(np.float32)
    knn = knn_index(p3dn, KNN)
    fnet = FlaxPoseNet(**{k: v for k, v in dp.POSE_CFG.items() if k != "dtype"},
                       dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, 256, 256, 3)), knn,
                                 jnp.zeros((1, NPT, 3)), stage=3, train=False,
                                 bn_scale=(0.3, 0.6))
    batch = _uneven_batch(rng, p3dn)
    pose = {"state_dict": flax_to_torch(variables), "knn": torch.from_numpy(knn),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    inputs = {
        "linear": {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for k, s in (("w", (4, 4)), ("b", (4,)), ("x", (8, 4)), ("y", (8, 4)))},
        "bn": {"x": torch.from_numpy(rng.standard_normal((8, 3, 5, 5)).astype(np.float32) * 2
                                     + 1),
               "r": torch.from_numpy(rng.standard_normal((8, 3, 5, 5)).astype(np.float32)),
               "weight": torch.tensor([0.5, 1.0, 1.5]), "bias": torch.tensor([0.1, -0.2, 0.3])},
        "losses": _loss_inputs(rng), "pose": pose, "solver": _solver_inputs(rng)}
    work = tmp_path_factory.mktemp("dp4")
    torch.save(inputs, work / "inputs.pt")
    ranks = dp.run("library_checks", 4, work, timeout=60)
    return dict(inputs=inputs, ranks=ranks, work=work, fnet=fnet, variables=variables,
                knn=knn, batch=batch)


def _state_report(want, got):
    """Leaves where got and want differ beyond test_sharding.py's bar."""
    report = []
    for name, a in want.items():
        a, b = a.double(), got[name].double()
        ad = float((a - b).abs().max()) if a.numel() else 0.0
        rd = float(((a - b).abs() / (a.abs() + 1e-6)).max()) if a.numel() else 0.0
        if not (ad < LEAF_ABS or rd < LEAF_REL):
            report.append((name, ad, rd))
    return sorted(report, key=lambda r: -r[1])


def test_mesh_without_and_with_torchrun_env(world4, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = pmesh.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.backend) == (0, 1, None, None)
    assert mesh.device == torch.device("cpu") and mesh.lead and mesh.batch_group is None
    with pytest.raises(ValueError, match="model axis"):
        pmesh.make_mesh("cpu", n_model=2)
    got = [r["mesh"] for r in world4["ranks"]]
    assert got == [{"rank": r, "world": 4, "backend": "gloo", "device": "cpu", "group": True}
                   for r in range(4)]


def test_shard_batch_rows_and_scalars(world4):
    x = torch.arange(16.0).view(8, 2)
    for r, res in enumerate(world4["ranks"]):
        torch.testing.assert_close(res["shard"]["x"], x[2 * r:2 * r + 2], rtol=0, atol=0)
        assert float(res["shard"]["s"]) == 3.0
    one = pmesh.Mesh(0, 1, torch.device("cpu"))
    np_batch = {"x": np.arange(6).reshape(3, 2), "s": np.float32(2.0)}
    assert np.array_equal(pmesh.shard_batch(np_batch, one)["x"], np_batch["x"])
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch(np_batch, pmesh.Mesh(0, 2, torch.device("cpu")))


def test_make_global_batch(world4):
    """One process: the local batch is the global one; several: it is
    returned when every rank holds the same keys and leading size, refused
    otherwise."""
    batch = {"x": np.arange(32, dtype=np.float32).reshape(8, 4), "s": np.float32(2.0)}
    assert pmesh.make_global_batch(batch, pmesh.Mesh(0, 1, torch.device("cpu"))) is batch
    assert all(r["global_batch_same"] for r in world4["ranks"])
    assert [r["global_batch_mismatch"] for r in world4["ranks"]] == ["refused"] * 4


def test_shard_manifest_partition():
    samples = list(range(10))
    parts = [pmesh.shard_manifest(samples, i, 4) for i in range(4)]
    assert sorted(sum(parts, [])) == samples and parts[0] == [0, 4, 8]
    assert parts == [jshard_manifest(samples, i, 4) for i in range(4)]


@pytest.mark.parametrize("w", [2, 4])
def test_dp_grad_equals_single_process(world4, w):
    """A Linear's mean squared error: the gradient summed over the ranks
    equals one process's, and JAX's."""
    lin = world4["inputs"]["linear"]
    want = dp.linear_case(lin)

    def loss(p, x, y):
        return jnp.mean((x @ p["w"].T + p["b"] - y) ** 2)

    jg = jax.grad(loss)({"w": jnp.asarray(lin["w"].numpy()), "b": jnp.asarray(lin["b"].numpy())},
                        jnp.asarray(lin["x"].numpy()), jnp.asarray(lin["y"].numpy()))
    for res in world4["ranks"][:w]:
        got = res[f"linear{w}"]
        for k, jk in (("weight", "w"), ("bias", "b")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-5, atol=1e-6)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(jg[jk]), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("w", [2, 4])
def test_batchnorm_global_statistics(world4, w):
    """Train-mode BatchNorm over its ranks' rows equals one process on the
    concatenated batch: outputs, input and parameter gradients through the
    autograd-aware all-reduce, and the running statistics on every rank."""
    want = dp.batchnorm_case(world4["inputs"]["bn"])
    rows = 8 // w
    for r, res in enumerate(world4["ranks"][:w]):
        got = res[f"bn{w}"]
        for k in ("y", "x_grad"):
            torch.testing.assert_close(got[k], want[k][r * rows:(r + 1) * rows],
                                       rtol=1e-5, atol=1e-6)
        for k in ("w_grad", "b_grad", "running_mean", "running_var"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(dp.LOSS_CASES))
def test_loss_at_w2_equals_concatenated_batch(world4, name):
    """Each rank's part of a loss, summed over the 2 ranks, equals the loss
    of the concatenated batch, and each rank's gradient its rows of the
    one-process gradient. The masks leave the shards uneven (12 and 15
    masked keypoints, one row with none)."""
    want, want_g = dp.loss_case(name, world4["inputs"]["losses"])
    for r, res in enumerate(world4["ranks"][:2]):
        got, got_g = res["losses2"][name]
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
        for k, g in want_g.items():
            torch.testing.assert_close(got_g[k], g[4 * r:4 * r + 4], rtol=1e-5, atol=1e-7)


def _single_pose_step(world4, opts, lr):
    pose = world4["inputs"]["pose"]
    st = dp.pose_state(pose, lr)
    return dp.pose_step(pose, st, opts), dp.state_tensors(st)


@pytest.fixture(scope="module")
def single_aug(world4):
    return _single_pose_step(world4, dp.AUG_OPTS, dp.DP_LR)


@pytest.mark.parametrize("w", [2, 4])
def test_dp_posenet_step_equals_single_process(world4, single_aug, w):
    """The PoseNet step with augmentation and teacher forcing, W ranks
    against one process on the 4-row batch: the loss, every parameter and
    running statistic after the step (SGD at dp.DP_LR), equal on every rank.
    DDP's per-rank normalizers on the same batch miss the bar, so the case
    discriminates."""
    metrics, want = single_aug
    res = [r[f"pose{w}"] for r in world4["ranks"][:w]]
    np.testing.assert_allclose(float(res[0]["metrics"]["loss"]), float(metrics["loss"]),
                               rtol=1e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(res[0]["metrics"][k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert all(r["spread"] == 0.0 for r in res)
    report = _state_report(want, res[0]["state"])
    assert not report, f"{len(report)} divergent leaves, worst: {report[:5]}"
    if w == 4:
        naive = world4["ranks"][0]["pose4_per_rank"]
        assert _state_report(want, naive["state"])
        assert abs(naive["loss"] - float(metrics["loss"])) > 1e-3 * float(metrics["loss"])


def test_dp_step_at_w2_matches_jax(world4):
    """The W=2 step (augmentation off, which JAX draws from another stream)
    against JAX's `make_train_step` on the same batch and weights: the loss
    terms to 1e-4, the gradients at test_torch_train_steps.py's two-tier
    bars, the running statistics to 1e-4."""
    opt = optax.sgd(1.0)
    variables = world4["variables"]
    params = jax.tree.map(np.asarray, variables["params"])
    state = {"params": jax.tree.map(jnp.array, params),
             "batch_stats": jax.tree.map(jnp.array, variables["batch_stats"]),
             "opt_state": opt.init(params)}
    step = jsteps.make_train_step(world4["fnet"], world4["knn"], opt, stage=dp.POSE_STAGE,
                                  use_pepper_salt=False, use_motion_blur=False,
                                  color_aug_prob=0.0)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in world4["batch"].items()},
                        jax.random.PRNGKey(0))
    grads = flax_to_torch({"params": jax.tree.map(lambda p, q: p - np.asarray(q), params,
                                                  new["params"])})
    got = world4["ranks"][0]["jax2"]
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got["metrics"][k]), float(v), err_msg=k, **LOSS_TOL)
    p0 = world4["inputs"]["pose"]["state_dict"]
    scale = max(float(g.abs().max()) for g in grads.values())
    num = den = 0.0
    for name, want in grads.items():
        diff = (p0[name] - got["state"][name]) - want
        noise = 4e-7 * float(p0[name].abs().max())
        if name.startswith(("seg_block.", "init_net.mlp.")) or ".query_" in name:
            assert float(diff.abs().max()) <= HEAD_TOL * float(want.abs().max()) + noise, name
        if float(want.abs().max()) > 1e-3 * scale:
            assert float(diff.norm()) <= LEAF_L2_TOL * float(want.norm()), name
        else:
            assert float(diff.abs().max()) <= 1e-3 * scale + noise, name
        num += float(diff.norm()) ** 2
        den += float(want.norm()) ** 2
    assert (num / den) ** 0.5 < GLOBAL_L2_TOL
    for name, want in flax_to_torch({"batch_stats": new["batch_stats"]}).items():
        np.testing.assert_allclose(got["state"][name].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_sharded_solver_equals_unsharded(world4):
    """Each rank solves its rows with its rows of hypotheses drawn for the
    whole batch; together they give the one-process poses."""
    inp = world4["inputs"]["solver"]
    want = solve_poses_batched(inp["p3d"], inp["p2d"], inp["valid"], inp["K"],
                               torch.Generator().manual_seed(0), device="cpu",
                               num_hyp=inp["num_hyp"])
    R = torch.cat([r["solver"]["R"] for r in world4["ranks"]])
    t = torch.cat([r["solver"]["t"] for r in world4["ranks"]])
    torch.testing.assert_close(R, want["R"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(t, want["t"], rtol=1e-3, atol=1e-2)


def test_run_training_at_w2(world4):
    """run_training on 2 ranks: equal parameters on both, rank 0 alone
    writes the metrics and the checkpoints, a fresh state restores the same
    tensors on both ranks and runs on."""
    res = [r["run_training"] for r in world4["ranks"][:2]]
    for r in res:
        assert (r["first_step"], r["restored_step"], r["resumed_step"]) == (3, 3, 4)
        assert r["first_spread"] == r["resumed_spread"] == 0.0 and r["restored_equal"]
    assert [r["evals"] for r in res] == [3, 0]             # evals at 2, 3, 4 on rank 0 only
    lines = (world4["work"] / "tb" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 + 3                             # a line a step and an eval
    ckpt = CheckpointManager(str(world4["work"] / "ckpt"))
    assert ckpt.latest_step() == 4 and sorted(os.listdir(ckpt.best_dir)) == ["4"]
    logs = [(world4["work"] / f"rank{r}.log").read_text() for r in range(2)]
    assert "step 3/3" in logs[0] and "eval @ 4" in logs[0] and "step " not in logs[1]


def test_pretrain_cli_under_torchrun_at_w2(tmp_path):
    """The pretrain CLI's main on 2 ranks with torchrun's environment, 2
    iterations on a tiny fixture at global batch 4: gloo, equal parameters,
    2 rows a rank, checkpoints and metrics from rank 0."""
    data = tmp_path / "data"
    make_synthetic_bop(str(data), n_objects=1, n_scenes=1, folders={"test": 2, "train_real": 4},
                       n_vertices=64, raw_cache=True, write_png=False)
    cfg = common.resolve_cfg("config/synth/init_gnn2_hrnetw18_npt512_synth.txt", "obj01", dict(
        network_backbone_name="hrnet_w18_small", num_p3d_log2=4, network_graph_k=5,
        batch_size=4, device="cpu", bop_path=str(data), check_point_path=str(tmp_path / "ck"),
        tensorboard_path=str(tmp_path / "tb"), total_iteration=2, test_freq=2, log_freq=1))
    cfg.pop("backbone_pretrain_checkpoint")
    res = dp.run("cli_pretrain", 2, tmp_path / "ranks", cfg, timeout=60)
    assert [(r["step"], r["world"], r["backend"], r["spread"], r["batch_rows"]) for r in res] \
        == [(2, 2, "gloo", 0.0, 2)] * 2
    ckpt = CheckpointManager(cfg["check_point_path"])
    assert ckpt.latest_step() == 2 and len(os.listdir(ckpt.best_dir)) == 1
    with open(os.path.join(cfg["tensorboard_path"], "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 2 + 1


def test_chip_smoke_parallel_phase_rehearsed_on_cpu(tmp_path):
    """phase_parallel at tiny size on the CPU: (a) the train CLI at world
    size 1 over gloo in a process of its own, (b) two gloo ranks on CPU
    tensors against one process, (c) the test CLI on a small PNG fixture on
    the native and the python path; every gate runs, nothing launches off
    the card and no device number is made up."""
    small = dict(init_network_backbone_name="hrnet_w18_small", num_p3d_log2=4,
                 network_graph_k=5, init_network_graph_k=5, network_num_graph_module=1,
                 batch_size=4)
    res = chip_smoke.phase_parallel(
        torch.device("cpu"), root=tmp_path, batch=4, iters=2, test_freq=1, log_freq=1,
        cfg_overrides=small, step_batch=4, native_test=8, native_scenes=1, native_vertices=64,
        step_cfg={**{k: v for k, v in dp.POSE_CFG.items() if k != "dtype"}, "knn_k": KNN},
        timeout=240)
    train = res["dp_train"]
    assert (train["backend"], train["world"], train["eval_batches"]) == ("gloo", 1, [1, 1])
    assert train["launches"] == {"tc": 0, "fma": 0}                    # no card, no launch
    assert train["saves"][:2] == [["rolling", 1], ["best", 1]]
    for key in ("eval_s", "ms_per_iter", "peak_mem_gib", "process_s"):
        assert train[key] is None
    step = res["dp_step"]
    assert step["loss_rel_err"] < 1e-4 and step["gate"].startswith("per leaf")
    assert len(step["argmax_flipped_per_edgeconv"]) == 1 + 3     # init net + 3 stages
    native = res["native_loader"]
    assert native["runs"]["native"]["native_counts"] == {"items": 8, "batches": 2}
    assert native["runs"]["python"]["native_counts"] == {"items": 0, "batches": 0}
    assert native["first_batch_image_max_abs_diff"] <= 1 and native["native_left_out"] is None
    assert all(native["first_batch_exact"].values()) and native["fixture_s"] is None
    for run in native["runs"].values():
        assert run["launches"] == {"tc": 0, "fma": 0} and run["images_per_s"] is None
        assert run["loader_wait_ms_per_batch"] is None and run["cli_wall_s"] is None
    assert sorted(chip_smoke.parallel_launches(res)) == [
        "parallel_dp_train", "parallel_native_loader_test", "parallel_python_loader_test"]
    json.dumps(res)                              # the phase's JSON line serialises
