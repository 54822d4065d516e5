"""Port train/state.py, train/checkpoint.py, train/loop.py and the
optimizer-state half of models/convert.py: Adam on given gradients against
optax across the two-phase rate's boundary, the state carried across both
ways, checkpoint retention and restore, the loop's order of save, eval and
best save. Small modules on the CPU."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.models.graph import EdgeConv as FlaxEdgeConv
from checkerpose_tpu.ops.knn import knn_index
from checkerpose_tpu.train import state as jstate
from checkerpose_tpu_torch.models.convert import (adam_state_to_flax, adam_state_to_torch,
                                                  flax_to_torch, torch_to_flax)
from checkerpose_tpu_torch.models.graph import EdgeConv
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.posenet import PoseNet
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.loop import run_training
from checkerpose_tpu_torch.train.state import (TrainState, TwoPhaseAdam, create_init_state,
                                               create_pose_state, graft_init_params,
                                               make_optimizer, param_count)
from checkerpose_tpu_torch.utils.logging import MetricWriter
from torch_parity import few_torch_threads, random_variables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

N, K, C, CP = 12, 4, 8, 6


def _edge_pair(seed=0):
    rng = np.random.default_rng(seed)
    knn = knn_index(rng.standard_normal((N, 3)), K)
    fmod = FlaxEdgeConv(CP, 0.2, dtype=jnp.float32)
    variables = random_variables(fmod, jnp.zeros((1, N, C)), knn, False, seed=seed)
    mod = EdgeConv(C, CP, dtype=torch.float32)
    mod.load_state_dict(flax_to_torch(variables))
    return variables, mod


def _given_grads(params, rng):
    """One gradient tree; some entries at rounding-noise size, where Adam's
    first update is still about +-lr."""
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                   * rng.choice([1.0, 1e-3, 1e-7], p.shape)).astype(np.float32),
                        params)


def _set_grads(mod, grads):
    for name, g in flax_to_torch({"params": grads}).items():
        dict(mod.named_parameters())[name].grad = g.clone()


def _assert_params(mod, params, tol):
    got = torch_to_flax(mod.state_dict())["params"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol),
                 got, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("lr2_start", [None, 2])
def test_adam_on_given_gradients_matches_optax(lr2_start):
    """Three updates from given gradients; with the two-phase rate the
    boundary (update number 2, counted from 0) lies inside. The rates are
    1e-2 and 1e-3, and the parameters agree to 5e-7 after every update: a
    few f32 roundings of parameters of size 1, and a twentieth of a percent
    of the smaller rate."""
    rng = np.random.default_rng(1)
    variables, mod = _edge_pair()
    lr, lr2 = 1e-2, (1e-3 if lr2_start is not None else None)
    jopt = jstate.make_optimizer(lr, lr2, lr2_start)
    opt = make_optimizer(lr, lr2, lr2_start)(mod.parameters())
    params = variables["params"]
    jst = jopt.init(params)
    before = jax.tree.map(np.asarray, params)
    for i in range(3):
        grads = _given_grads(params, rng)
        updates, jst = jopt.update(grads, jst, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        _set_grads(mod, grads)
        opt.step()
        _assert_params(mod, params, 5e-7)
        want_lr = lr if lr2_start is None or i < lr2_start else lr2
        assert opt.param_groups[0]["lr"] == want_lr
    moved = jax.tree.map(lambda a, b: float(np.abs(a - np.asarray(b)).max()), before, params)
    assert min(jax.tree.leaves(moved)) > 5e-3


def _optax_adam_parts(jst):
    adam = jst[0]                                  # ScaleByAdamState(count, mu, nu)
    return int(adam.count), jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu)


def test_optimizer_state_crosses_both_ways():
    """Two optax updates, the state carried into the port (count, mu, nu ->
    Adam.state_dict), a third update on both sides with the same gradients:
    equal to 5e-7, across the lr2 boundary, which only a carried count gets
    right. Then the port's state carried back equals optax's."""
    rng = np.random.default_rng(2)
    variables, mod = _edge_pair(1)
    lr, lr2, lr2_start = 1e-2, 1e-3, 2
    jopt = jstate.make_optimizer(lr, lr2, lr2_start)
    params = variables["params"]
    jst = jopt.init(params)
    for _ in range(2):
        updates, jst = jopt.update(_given_grads(params, rng), jst, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    mod.load_state_dict(flax_to_torch({"params": jax.tree.map(np.asarray, params),
                                       "batch_stats": variables["batch_stats"]}))
    opt = make_optimizer(lr, lr2, lr2_start)(mod.parameters())
    count, mu, nu = _optax_adam_parts(jst)
    assert count == 2
    adam_state_to_torch(mod, opt, count, mu, nu)
    assert opt.param_groups[0]["count"] == 2
    grads = _given_grads(params, rng)
    updates, jst = jopt.update(grads, jst, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
    _set_grads(mod, grads)
    opt.step()
    assert opt.param_groups[0]["lr"] == lr2
    _assert_params(mod, params, 5e-7)
    count, mu, nu = adam_state_to_flax(mod, opt)
    jcount, jmu, jnu = _optax_adam_parts(jst)
    assert count == jcount == 3
    for got, want in ((mu, jmu), (nu, jnu)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12),
                     got, want)
    # a fresh optimizer reads as optax's init: count 0, zero moments
    fresh = make_optimizer(lr)(mod.parameters())
    count, mu, _ = adam_state_to_flax(mod, fresh)
    assert count == 0 and all(float(np.abs(m).max()) == 0 for m in jax.tree.leaves(mu))
    with pytest.raises(KeyError):
        adam_state_to_torch(mod, fresh, 1, {"conv": mu["conv"]}, nu)


def test_two_phase_adam_count_survives_state_dict():
    _, mod = _edge_pair(2)
    opt = TwoPhaseAdam(mod.parameters(), 1e-2, 1e-3, 1)
    for p in mod.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    other = TwoPhaseAdam(mod.parameters(), 1e-2, 1e-3, 1)
    other.load_state_dict(opt.state_dict())
    assert other.param_groups[0]["count"] == 1
    other.step()
    assert other.param_groups[0]["lr"] == 1e-3 and other.param_groups[0]["count"] == 2


# --- states ---------------------------------------------------------------------

NPT = 8
INIT_CFG = dict(npoint=NPT, res_log2=3, backbone_name="hrnet_w18_small", num_graph_module=1)
POSE_CFG = dict(npoint=NPT, res_log2=6, backbone_name="hrnet_w18_small", num_graph_module=1,
                init_num_graph_module=1)


def test_create_states_graft_and_param_count(capsys):
    init_net = InitNet(**INIT_CFG, dtype=torch.float32)
    ist = create_init_state(init_net, make_optimizer(1e-4), seed=3, device="cpu")
    assert ist.module is init_net and init_net.training and ist.step == 0
    assert ist.best_score == -1.0 and isinstance(ist.optimizer, torch.optim.Adam)
    again = create_init_state(InitNet(**INIT_CFG, dtype=torch.float32), make_optimizer(1e-4),
                              seed=3, device="cpu")
    assert torch.equal(again.module.mlp.weight, init_net.mlp.weight)     # seeded init
    with torch.no_grad():                      # mark the pretrained net, statistics too
        for t in init_net.state_dict().values():
            t.add_(7.0)
    bundle = {"model": dict(init_net.state_dict(), stray=torch.zeros(1)), "step": 5}
    pose = PoseNet(**POSE_CFG, dtype=torch.float32)
    pst = create_pose_state(pose, make_optimizer(1e-4, 1e-5, 10), seed=0, init_params=bundle,
                            device="cpu")
    assert isinstance(pst.optimizer, TwoPhaseAdam) and pose.training
    for k, v in init_net.state_dict().items():
        assert torch.equal(pose.init_net.state_dict()[k], v), k
    said = capsys.readouterr().out
    assert "stray" in said and f"loaded {len(init_net.state_dict())} entries" in said
    assert float(pose.up_0.conv1.weight.abs().max()) < 3.0               # the rest untouched
    # a bare state_dict grafts too
    graft_init_params(PoseNet(**POSE_CFG, dtype=torch.float32), init_net.state_dict())
    assert 10.0 < param_count(pose) < 30.0
    assert param_count(pose) == sum(p.numel() for p in pose.parameters()) / 1e6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_pose_state(pose, make_optimizer(1e-4))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_init_state(init_net, make_optimizer(1e-4))


# --- checkpoints ------------------------------------------------------------------

def _small_state(seed=0):
    _, mod = _edge_pair(seed)
    return TrainState(module=mod.train(),
                      optimizer=make_optimizer(1e-2, 1e-3, 4)(mod.parameters()))


def _train_some(state, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    knn = torch.from_numpy(knn_index(np.random.default_rng(0).standard_normal((N, 3)), K))
    for _ in range(n):
        x = torch.randn(2, N, C, generator=g)
        state.optimizer.zero_grad()
        state.module(x, knn).square().mean().backward()
        state.optimizer.step()
        state.step += 1


def _assert_same_state(a: TrainState, b: TrainState):
    for (k, v), w in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(v, w), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)


def test_checkpoint_keep3_best_and_restore_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_small_state())
    state = _small_state()
    for _ in range(5):
        _train_some(state, 1)
        state.best_score = 0.1 * state.step
        mgr.save(state)
    mgr.wait()
    kept = sorted(int(d) for d in os.listdir(mgr.dir) if d.isdigit())
    assert kept == [3, 4, 5] and mgr.latest_step() == 5          # rolling keep-3 by step
    live = state
    restored = mgr.restore(_small_state(1))
    assert restored.step == 5 and restored.best_score == pytest.approx(0.5)
    _assert_same_state(restored, live)
    # two more steps from the restored state equal two more of the live one
    _train_some(live, 2, seed=9)
    _train_some(restored, 2, seed=9)
    _assert_same_state(restored, live)
    assert restored.optimizer.param_groups[0]["lr"] == 1e-3      # past the lr2 boundary
    older = mgr.restore(_small_state(2), step=3)
    assert older.step == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore(_small_state(2), step=1)                     # rolled away


def test_checkpoint_best_record_and_metric_tagged_floor(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = _small_state()
    assert mgr.best_floor("test_acc") == float("-inf")
    _train_some(state, 1)
    state.best_score = 0.7
    mgr.save_best(state, metric="one_minus_mean_bit_err")
    rec = json.load(open(os.path.join(mgr.dir, "best_score.json")))
    assert rec == {"step": 1, "best_score": pytest.approx(0.7), "metric": "one_minus_mean_bit_err"}
    assert not os.path.exists(os.path.join(mgr.dir, ".best_score.json.tmp"))
    assert mgr.best_floor("one_minus_mean_bit_err") == pytest.approx(0.7)
    assert mgr.best_floor("test_acc") == float("-inf")           # another gate's record
    _train_some(state, 1)
    state.best_score = 0.9
    mgr.save_best(state, metric="one_minus_mean_bit_err")
    assert sorted(os.listdir(mgr.best_dir)) == ["2"]             # a single best
    # a rolling checkpoint saved before the eval carries a stale score: restore
    # takes the max with the side record; restoring the best itself does not
    state.best_score = 0.2
    mgr.save(state)
    assert mgr.restore(_small_state(1)).best_score == pytest.approx(0.9)
    best = mgr.restore(_small_state(1), best=True)
    assert best.step == 2 and best.best_score == pytest.approx(0.9)
    with open(os.path.join(mgr.dir, "best_score.json"), "w") as f:
        f.write("{ not json")
    assert mgr.best_floor("one_minus_mean_bit_err") == float("-inf")
    assert mgr.restore(_small_state(1)).best_score == pytest.approx(0.2)


def test_restore_eval_ignores_the_optimizer_and_restore_raw(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = _small_state()
    _train_some(state, 2)
    mgr.save(state)
    # an eval program built with a plain Adam: a structural restore of the
    # two-phase optimizer's groups is not needed
    _, mod = _edge_pair(5)
    plain = TrainState(module=mod, optimizer=make_optimizer(1e-4)(mod.parameters()))
    ev = mgr.restore_eval(plain)
    assert ev.step == 2 and ev.optimizer is plain.optimizer
    assert len(plain.optimizer.state_dict()["state"]) == 0
    for (k, v), w in zip(mod.state_dict().items(), state.module.state_dict().values()):
        assert torch.equal(v, w), k
    raw = mgr.restore_raw()
    assert sorted(raw) == ["best_score", "model", "optimizer", "step"] and raw["step"] == 2
    assert torch.equal(raw["model"]["conv.weight"], state.module.conv.weight)


# --- the loop -----------------------------------------------------------------------

def test_run_training_order_of_save_eval_and_best(tmp_path, capsys):
    """Cadence: log every 2, save every 2, eval every 4, 6 steps: the
    rolling save comes before the eval of the same step, the best save after
    it and only on a better gate score, the final step saves and evaluates,
    and the module is in eval mode inside eval_fn and back in train mode
    after."""
    events = []
    state = _small_state()
    knn = torch.from_numpy(knn_index(np.random.default_rng(0).standard_normal((N, 3)), K))

    class Recorder(CheckpointManager):
        def save(self, st):
            events.append(("save", st.step))
            super().save(st)

        def save_best(self, st, metric="test_acc"):
            events.append(("best", st.step, metric, round(st.best_score, 3)))
            super().save_best(st, metric)

    def step_fn(st, batch, generator):
        assert st.module.training and batch["x"].device == generator.device
        st.optimizer.zero_grad()
        noise = torch.rand((), generator=generator)
        loss = st.module(batch["x"] + batch["extra"], knn).square().mean() + 0 * noise
        loss.backward()
        st.optimizer.step()
        st.step += 1
        events.append(("step", st.step))
        return {"loss": loss.detach()}

    scores = iter([0.5, 0.4])                     # the second eval is worse

    def eval_fn(module):
        assert module is state.module and not module.training
        events.append(("eval", state.step))
        return {"test_acc": 0.0, "gate_score": next(scores), "gate_metric": "m", "n": 3}

    def loader():
        rng = np.random.default_rng(0)
        while True:
            yield {"x": rng.standard_normal((2, N, C)).astype(np.float32), "n_real": 2}

    writer = MetricWriter(str(tmp_path / "log"), use_tensorboard=False)
    ckpt = Recorder(str(tmp_path / "ckpt"))
    out = run_training(state=state, step_fns={None: step_fn}, loader=loader(),
                       total_iteration=6, eval_fn=eval_fn, ckpt=ckpt, writer=writer,
                       log_freq=2, test_freq=4, save_freq=2,
                       extra_batch=lambda b: dict(b, extra=np.float32(0.5)))
    writer.close()
    assert out is state and out.step == 6 and out.best_score == 0.5
    assert state.module.training
    assert events == [("step", 1), ("step", 2), ("save", 2), ("step", 3), ("step", 4),
                      ("save", 4), ("eval", 4), ("best", 4, "m", 0.5), ("step", 5), ("step", 6),
                      ("save", 6), ("eval", 6)]
    assert ckpt.best_floor("m") == 0.5 and ckpt.latest_step() == 6
    # the save before the first eval carries -inf, not a made-up score
    assert ckpt.restore_raw(step=2)["best_score"] == float("-inf")
    lines = [json.loads(l) for l in open(tmp_path / "log" / "metrics.jsonl")]
    assert [l["step"] for l in lines if "TRAIN/loss" in l] == [2, 4, 6]
    assert all("TRAIN/step_time_s" in l and "TRAIN/loader_wait_s" in l
               for l in lines if "TRAIN/loss" in l)
    assert [l["step"] for l in lines if "TESTDATA_ACC/ACC_test" in l] == [4, 6]
    said = capsys.readouterr().out
    assert "eval @ 4" in said and "gate[m]=0.5000 (best -inf)" in said

    # resumed: the gate's memory comes from the metric-tagged side record, so a
    # score of 0.45 is no new best; under another metric name it would be
    events.clear()
    scores = iter([0.45])
    resumed = ckpt.restore(_small_state(3))
    assert resumed.step == 6 and resumed.best_score == 0.5
    state = resumed
    out = run_training(state=resumed, step_fns={None: step_fn}, loader=loader(),
                       total_iteration=8, eval_fn=eval_fn, ckpt=ckpt,
                       writer=MetricWriter(str(tmp_path / "log"), use_tensorboard=False),
                       log_freq=100, test_freq=100, save_freq=100,
                       extra_batch=lambda b: dict(b, extra=np.float32(0.5)),
                       get_stage=None)
    assert [e for e in events if e[0] != "step"] == [("save", 8), ("eval", 8)]
    assert out.step == 8 and out.best_score == 0.5


def test_run_training_picks_the_stage_step(tmp_path):
    state = _small_state()
    calls = []

    def make(stage):
        def step_fn(st, batch, generator):
            calls.append(stage)
            st.step += 1
            return {"loss": torch.tensor(0.0)}
        return step_fn

    run_training(state=state, step_fns={1: make(1), 2: make(2)}, loader=iter(lambda: {}, None),
                 total_iteration=4, eval_fn=lambda m: {"test_acc": 0.0},
                 ckpt=CheckpointManager(str(tmp_path / "c")),
                 writer=MetricWriter(str(tmp_path / "l"), use_tensorboard=False),
                 log_freq=100, test_freq=100, get_stage=lambda s: 1 if s < 2 else 2)
    assert calls == [1, 1, 2, 2]
