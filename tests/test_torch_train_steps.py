"""Port train/steps.py vs checkerpose_tpu/train/steps.py at a small size
(hrnet_w18_small, 16 keypoints, K=5, batch 2, f32, CPU), same numpy inputs
and weights.

The JAX gradients come out of the package's own jitted step without touching
it: with `optax.sgd(1.0)` the step returns `params - grads`. Parity is held
on loss terms, gradients and new BatchNorm statistics, not on parameters
after an Adam update (Adam's first update is about +-lr whatever the size of
the gradient, so rounding noise in a tiny gradient flips whole updates;
Adam itself is held on given gradients in test_torch_train_state.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from checkerpose_tpu.models import InitNet as FlaxInitNet
from checkerpose_tpu.models import PoseNet as FlaxPoseNet
from checkerpose_tpu.ops.geometry import pc_normalize
from checkerpose_tpu.ops.knn import knn_index
from checkerpose_tpu.train import steps as jsteps
from checkerpose_tpu_torch.models.convert import flax_to_torch
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.posenet import PoseNet
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.state import (create_init_state, create_pose_state,
                                               make_optimizer)
from torch_parity import few_torch_threads, random_variables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

NPT, CROP, BATCH, KNN = 16, 256, 2, 5
CFG = dict(npoint=NPT, res_log2=6, backbone_name="hrnet_w18_small", num_graph_module=3,
           init_num_graph_module=2, local_k=2, aux_refine_heads=True)
INIT_CFG = dict(npoint=NPT, res_log2=3, backbone_name="hrnet_w18_small", num_graph_module=2)
ALL_OPTIONS = dict(aux_heatmap_weight=0.1, aux_refine_weight=0.2, coord_reg_weight=0.3,
                   bit_weights=(1.0, 1.0, 1.0, 1.0, 2.0, 2.0), prefix_correct_mask=True,
                   seg_visib_loss_weight=0.7, seg_full_loss_weight=1.3)
TF_PROB = 0.5
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
# Gradient leaves against their JAX values, in two tiers. The forwards agree
# to ~1e-4 (f32 through ~60 layers), and each EdgeConv takes 8192 maxima over
# K whose top two lie ~0.03 apart, so in a handful of them the argmax falls on
# another neighbour on the two sides and routes that entry's gradient
# elsewhere (the port in f64 differs from itself in f32 by just as much). With
# only B*N = 32 nodes one rerouted entry moves a weight gradient behind it by
# a few percent. So:
#   * the heads, whose gradient passes through no max (every stage's query
#     MLP, the init net's mlp, seg_block): 1e-3 of the leaf's largest entry;
#   * every leaf: relative L2 error below 0.1 where the leaf carries gradient,
#     and below 0.05 over all leaves together (measured: 0.045 and 0.021). A
#     wiring fault (a missing detach, a loss weight, a wrong label plane)
#     shows at order 1. EdgeConv's own backward is held to 1e-4 where it
#     stands alone (test_torch_train_layers.py).
HEAD_TOL, LEAF_L2_TOL, GLOBAL_L2_TOL = 1e-3, 0.1, 0.05


def _is_head(name):
    return name.startswith(("seg_block.", "init_net.mlp.", "mlp.")) or ".query_" in name


def _batch(rng):
    proj = np.stack([rng.uniform(40, 190, (BATCH, NPT)), rng.uniform(50, 200, (BATCH, NPT))],
                    -1).astype(np.float32)
    return {"image": rng.integers(0, 255, (BATCH, CROP, CROP, 3)).astype(np.uint8),
            "proj_xy": proj,
            "bbox": np.tile(np.array([50, 60, 130, 130], np.float32), (BATCH, 1)),
            "mask_visib": (rng.random((BATCH, 64, 64)) > 0.5).astype(np.float32),
            "mask_full": (rng.random((BATCH, 64, 64)) > 0.3).astype(np.float32)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_step(make, variables, batch, key):
    """One sgd(1.0) step of the package's jitted step: (grads, metrics, new
    batch_stats) as numpy. The step donates its state, so it gets a copy."""
    opt = optax.sgd(1.0)
    params = _np_tree(variables["params"])
    state = {"params": jax.tree.map(jnp.array, params),
             "batch_stats": jax.tree.map(jnp.array, variables["batch_stats"]),
             "opt_state": opt.init(params)}
    new, metrics = make(opt)(state, batch, key)
    grads = jax.tree.map(lambda p, q: p - np.asarray(q), params, new["params"])
    return grads, {k: float(v) for k, v in metrics.items()}, _np_tree(new["batch_stats"])


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_grads(net, jax_grads, variables):
    want = flax_to_torch({"params": jax_grads})
    params = flax_to_torch({"params": variables["params"]})
    grad_scale = max(float(w.abs().max()) for w in want.values())
    num = den = 0.0
    heads = 0
    for name, p in net.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        diff = got - want[name]
        # params - (params - grads) carries the parameters' f32 rounding
        noise = 4e-7 * float(params[name].abs().max())
        if _is_head(name):
            heads += 1
            assert float(diff.abs().max()) <= HEAD_TOL * float(want[name].abs().max()) + noise, name
        # a leaf whose gradient is zero by construction (the bias of a softmax
        # head) holds rounding noise on both sides: only leaves above 1e-3 of
        # the largest gradient entry are held to the relative bar
        if float(want[name].abs().max()) > 1e-3 * grad_scale:
            assert float(diff.norm()) <= LEAF_L2_TOL * float(want[name].norm()), name
        else:
            assert float(diff.abs().max()) <= 1e-3 * grad_scale, name
        num += float(diff.norm()) ** 2
        den += float(want[name].norm()) ** 2
    assert heads >= 2
    assert (num / den) ** 0.5 < GLOBAL_L2_TOL


def _check_stats(net, new_stats):
    for name, want in flax_to_torch({"batch_stats": new_stats}).items():
        got = dict(net.named_buffers())[name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def pose():
    rng = np.random.default_rng(0)
    p3d = rng.uniform(-30, 30, (NPT, 3)).astype(np.float32)
    p3dn = pc_normalize(p3d).astype(np.float32)
    knn = knn_index(p3dn, KNN)
    fnet = FlaxPoseNet(**CFG, dtype=jnp.float32)
    # train=True so that the aux heads' parameters exist
    variables = random_variables(fnet, jnp.zeros((1, CROP, CROP, 3)), knn,
                                 jnp.zeros((1, NPT, 3)), stage=3, train=True,
                                 bn_scale=(0.3, 0.6))
    batch = _batch(rng)
    batch["p3d_normed"] = np.tile(p3dn[None], (BATCH, 1, 1))

    def port():
        net = PoseNet(**CFG, dtype=torch.float32)
        net.load_state_dict(flax_to_torch(variables), strict=True)
        return net.train()

    return dict(fnet=fnet, variables=variables, knn=knn, batch=batch, port=port,
                knn_t=torch.from_numpy(knn))


def _imgs(batch):
    return steps.device_augment_normalize(torch.from_numpy(batch["image"]), None, False, False,
                                          train=False)


@pytest.mark.parametrize("case", ["reference_parity", "every_option"])
def test_train_step_matches_jax(pose, case):
    """make_train_step(stage=3): every loss term 1e-4, every gradient leaf
    within the two-tier bar above, new running statistics 1e-4; once
    with the reference-parity options and once with every option on
    (teacher forcing with the keypoints JAX selected, prefix-correct masks,
    bit weights, both auxiliary heatmap losses, coordinate regression,
    seg weights)."""
    s = pose
    key = jax.random.PRNGKey(3)
    opts, sel = {}, None
    if case == "every_option":
        opts = ALL_OPTIONS
        sel = np.asarray(jax.random.bernoulli(jax.random.split(key)[1], TF_PROB, (BATCH, NPT)))
        assert 0 < sel.sum() < sel.size
    tf = {"teacher_force_prob": TF_PROB} if sel is not None else {}
    grads, metrics, new_stats = _jax_step(
        lambda opt: jsteps.make_train_step(s["fnet"], s["knn"], opt, stage=3,
                                           color_aug_prob=0.0, **opts, **tf),
        s["variables"], s["batch"], key)
    net = s["port"]()
    total, got = steps.train_loss(net, s["knn_t"], _imgs(s["batch"]), _torch_batch(s["batch"]),
                                  3, sel=None if sel is None else torch.from_numpy(sel), **opts)
    assert sorted(got) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k].detach()), v, err_msg=k, **LOSS_TOL)
    total.backward()
    _check_grads(net, grads, s["variables"])
    _check_stats(net, new_stats)
    if case == "reference_parity":               # the aux heads saw no loss
        assert net.aux_resp_0.weight.grad is None


def test_posenet_train_forward_matches_flax(pose):
    """PoseNet in train mode with tf_gather and the aux heads vs Flax
    `apply(train=True, mutable=[batch_stats, intermediates])`: logits,
    response maps and ids. tf_gather forces every keypoint, so each refine
    gather reads the GT cell on both sides whatever the predicted ids."""
    s = pose
    rng = np.random.default_rng(5)
    gt_x = rng.integers(0, 64, (BATCH, NPT)).astype(np.int32)
    gt_y = rng.integers(0, 64, (BATCH, NPT)).astype(np.int32)
    gt_roi = (rng.random((BATCH, NPT, 1)) > 0.3).astype(np.float32)
    sel = np.ones((BATCH, NPT), bool)
    imgs = _imgs(s["batch"])
    ref, upd = jax.jit(lambda v, im: s["fnet"].apply(
        v, im, s["knn"], None, stage=3, train=True, mutable=["batch_stats", "intermediates"],
        tf_gather=(jnp.asarray(gt_x), jnp.asarray(gt_y), jnp.asarray(gt_roi),
                   jnp.asarray(sel))))(s["variables"], jnp.asarray(imgs.numpy()))
    net = s["port"]()
    with torch.no_grad():
        out = net(imgs, s["knn_t"], stage=3,
                  tf_gather=tuple(torch.from_numpy(a) for a in (gt_x, gt_y, gt_roi, sel)))
    for k in ("roi_logit", "x_logits", "y_logits", "seg_logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    inter = upd["intermediates"]
    np.testing.assert_allclose(out["resp_map"].numpy(),
                               np.asarray(inter["init_net"]["resp_map"][0]), rtol=1e-3, atol=1e-3)
    for i in range(3):
        want = np.asarray(inter[f"refine_resp_{i}"][0])
        assert out[f"refine_resp_{i}"].shape == want.shape == (BATCH, NPT, 4 ** (4 + i))
        np.testing.assert_allclose(out[f"refine_resp_{i}"].numpy(), want, rtol=1e-3, atol=1e-3)
    for k in ("x_id", "y_id"):
        assert (out[k].numpy() == np.asarray(ref[k])).mean() > 0.95
    _check_stats(net, _np_tree(upd["batch_stats"]))
    # in eval mode the train-only outputs are gone and tf_gather is ignored
    with torch.no_grad():
        ev = net.eval()(imgs, s["knn_t"], stage=3,
                        tf_gather=tuple(torch.from_numpy(a) for a in (gt_x, gt_y, gt_roi, sel)))
    assert sorted(ev) == ["roi_logit", "seg_logits", "x_id", "x_logits", "y_id", "y_logits"]


def test_aux_heads_are_in_the_state_dict_only_when_asked_for():
    with_heads = PoseNet(**CFG, dtype=torch.float32)
    without = PoseNet(**{**CFG, "aux_refine_heads": False}, dtype=torch.float32)
    extra = sorted(set(with_heads.state_dict()) - set(without.state_dict()))
    assert extra == sorted(f"aux_resp_{i}.{leaf}" for i in range(3) for leaf in ("bias", "weight"))
    with pytest.raises(ValueError, match="aux_refine_heads"):
        steps.make_train_step(without, torch.zeros(NPT, KNN, dtype=torch.int32), 3,
                              aux_refine_weight=0.1)


@pytest.fixture(scope="module")
def init():
    rng = np.random.default_rng(1)
    p3d = rng.uniform(-30, 30, (NPT, 3)).astype(np.float32)
    knn = knn_index(pc_normalize(p3d), KNN)
    fnet = FlaxInitNet(**INIT_CFG, dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, CROP, CROP, 3)), knn, train=False,
                                 bn_scale=(0.3, 0.6), seed=1)
    return dict(fnet=fnet, variables=variables, knn=knn, batch=_batch(rng))


def _port_init(s):
    net = InitNet(**INIT_CFG, dtype=torch.float32)
    net.load_state_dict(flax_to_torch(s["variables"]), strict=True)
    return net


def test_pretrain_step_matches_jax(init):
    """make_pretrain_step with the auxiliary heatmap loss on, labels at
    crop_size_gt 64 cut to the 3 MSB planes: loss terms 1e-4, gradient
    leaves within the two-tier bar above, new running statistics 1e-4."""
    s = init
    opts = dict(aux_heatmap_weight=0.1, proj_bit_loss_weight=0.8)
    grads, metrics, new_stats = _jax_step(
        lambda opt: jsteps.make_pretrain_step(s["fnet"], s["knn"], opt, crop_size_gt=64,
                                              color_aug_prob=0.0, **opts),
        s["variables"], s["batch"], jax.random.PRNGKey(0))
    net = _port_init(s).train()
    total, got = steps.pretrain_loss(net, torch.from_numpy(s["knn"]), _imgs(s["batch"]),
                                     _torch_batch(s["batch"]), 64, **opts)
    assert sorted(got) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k].detach()), v, err_msg=k, **LOSS_TOL)
    total.backward()
    _check_grads(net, grads, s["variables"])
    _check_stats(net, new_stats)


def test_init_eval_step_matches_jax(init):
    s = init
    ref = jsteps.make_init_eval_step(s["fnet"], s["knn"], crop_size_gt=64)(s["variables"],
                                                                            s["batch"])
    net = _port_init(s)
    ev = steps.make_init_eval_step(net, torch.from_numpy(s["knn"]), crop_size_gt=64)
    with pytest.raises(RuntimeError, match="eval mode"):
        ev(_torch_batch(s["batch"]))               # a fresh module is in train mode
    net.eval()
    out = ev(_torch_batch(s["batch"]))
    assert out["bit_err"].shape == (BATCH, 7)
    for k, v in ref.items():
        # a bit whose logit sits at f32 noise of 0 may flip: 1/16 of a keypoint row
        np.testing.assert_allclose(out[k].numpy(), np.asarray(v), atol=0.07, err_msg=k)
        assert np.abs(out[k].numpy() - np.asarray(v)).mean() < 0.01, k


def test_steps_train_in_place_and_want_train_mode(init, pose):
    """The steps themselves, on the CPU: parameters, BN statistics and Adam
    state change in place, `state.step` counts, the loss of a fixed batch
    falls over a few steps, the same seed gives the same run, and a module in
    eval mode or another module than the state's is refused."""
    s = init
    gen = torch.Generator().manual_seed(0)
    batch = _torch_batch(s["batch"])
    runs = []
    for _ in range(2):
        net = _port_init(s)
        state = create_init_state(net, make_optimizer(1e-3), seed=None, device="cpu")
        assert net.training and state.step == 0
        step = steps.make_pretrain_step(net, torch.from_numpy(s["knn"]), 64)
        gen.manual_seed(7)
        w0 = net.mlp.weight.detach().clone()
        m0 = net.backbone.stem1.bn.running_mean.clone()
        losses = [float(step(state, batch, gen)["loss"]) for _ in range(3)]
        assert state.step == 3 and np.isfinite(losses).all()
        assert not torch.equal(net.mlp.weight, w0)
        assert not torch.equal(net.backbone.stem1.bn.running_mean, m0)
        assert len(state.optimizer.state_dict()["state"]) == len(list(net.parameters()))
        runs.append(losses)
    assert runs[0] == runs[1]                      # augmentation draws from the generator
    net.eval()
    with pytest.raises(RuntimeError, match="train mode"):
        step(state, batch, gen)
    other = create_init_state(_port_init(s), make_optimizer(1e-3), seed=None, device="cpu")
    with pytest.raises(ValueError, match="another module"):
        step(other, batch, gen)

    p = pose
    net = p["port"]()
    state = create_pose_state(net, make_optimizer(1e-3), seed=None, device="cpu")
    step = steps.make_train_step(net, p["knn_t"], 3, color_aug_prob=0.0,
                                 teacher_force_prob=0.5, **ALL_OPTIONS)
    batch = _torch_batch(p["batch"])
    losses = [float(step(state, batch, gen)["loss"]) for _ in range(3)]
    assert state.step == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_pose_forward_wants_eval_mode_and_matches_its_parts(pose):
    p = pose
    net = p["port"]()
    fwd = steps.make_pose_forward(net, p["knn_t"], 3)
    with pytest.raises(RuntimeError, match="eval mode"):
        fwd(_torch_batch(p["batch"]))
    net.eval()
    out = fwd(_torch_batch(p["batch"]))
    assert sorted(out) == ["roi_mask", "seg_full", "seg_visib", "x_id", "x_logits", "y_id",
                           "y_logits"]
    assert out["seg_visib"].shape == (BATCH, 64, 64) and out["x_id"].shape == (BATCH, NPT)
    assert 0.0 <= float(out["seg_visib"].min()) and float(out["seg_visib"].max()) <= 1.0


# --- the steps' helpers -------------------------------------------------------

def _labels(rng, B=3, N=12, bits=6):
    roi = (rng.random((B, N, 1)) > 0.3).astype(np.float32)
    x_id = rng.integers(0, 2 ** bits, (B, N)).astype(np.int32)
    y_id = rng.integers(0, 2 ** bits, (B, N)).astype(np.int32)
    return roi, x_id, y_id


@pytest.mark.parametrize("total_bits", [6, 7])
def test_aux_heatmap_loss(total_bits):
    rng = np.random.default_rng(total_bits)
    roi, x_id, y_id = _labels(rng, bits=total_bits)
    resp = rng.standard_normal((3, 12, 64)).astype(np.float32)
    ref = float(jsteps._aux_heatmap_loss(*map(jnp.asarray, (resp, roi, x_id, y_id)), total_bits))
    got = float(steps._aux_heatmap_loss(*map(torch.from_numpy, (resp, roi, x_id, y_id)),
                                        total_bits))
    np.testing.assert_allclose(got, ref, **LOSS_TOL)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_aux_refine_loss(stage):
    rng = np.random.default_rng(10 + stage)
    roi, x_id, y_id = _labels(rng)
    resp = {f"refine_resp_{i}": rng.standard_normal((3, 12, 4 ** (4 + i))).astype(np.float32)
            for i in range(stage)}
    ref = float(jsteps._aux_refine_loss({k: (jnp.asarray(v),) for k, v in resp.items()},
                                        *map(jnp.asarray, (roi, x_id, y_id)), 6, stage))
    got = float(steps._aux_refine_loss({k: torch.from_numpy(v) for k, v in resp.items()},
                                       *map(torch.from_numpy, (roi, x_id, y_id)), 6, stage))
    np.testing.assert_allclose(got, ref, **LOSS_TOL)


@pytest.mark.parametrize("active_bits", [4, 6])
def test_coord_reg_loss_and_continuous_coords(active_bits):
    rng = np.random.default_rng(20 + active_bits)
    B, N = 3, 12
    batch = {"proj_xy": rng.uniform(40, 200, (B, N, 2)).astype(np.float32),
             "bbox": np.array([[50, 60, 130, 130], [20, 30, 100, 100], [5, 5, 0, 0]], np.float32)}
    jx, jy = jsteps.continuous_rel_coords({k: jnp.asarray(v) for k, v in batch.items()}, 64)
    tx, ty = steps.continuous_rel_coords(_torch_batch(batch), 64)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-5)
    roi = (rng.random((B, N, 1)) > 0.3).astype(np.float32)
    xl = rng.standard_normal((B, N, active_bits)).astype(np.float32)
    yl = rng.standard_normal((B, N, active_bits)).astype(np.float32)
    ref = float(jsteps._coord_reg_loss(jnp.asarray(xl), jnp.asarray(yl), jx, jy,
                                       jnp.asarray(roi), active_bits, 6))
    got = float(steps._coord_reg_loss(torch.from_numpy(xl), torch.from_numpy(yl), tx, ty,
                                      torch.from_numpy(roi), active_bits, 6))
    np.testing.assert_allclose(got, ref, **LOSS_TOL)


def test_device_labels_and_code_label_bits():
    rng = np.random.default_rng(30)
    batch = {"proj_xy": rng.uniform(40, 200, (3, 12, 2)).astype(np.float32),
             "bbox": np.tile(np.array([50, 60, 130, 130], np.float32), (3, 1))}
    ref = jsteps.device_labels({k: jnp.asarray(v) for k, v in batch.items()}, 64)
    got = steps.device_labels(_torch_batch(batch), 64)
    assert got[0].shape == (3, 12, 1)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    jb = jsteps._code_labels_bits(ref[1], ref[2], 6, 4)
    tb = steps._code_labels_bits(got[1], got[2], 6, 4)
    for g, r in zip(tb, jb):
        assert g.dtype == torch.float32 and g.shape == (3, 12, 4)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("args", [(0, 0.5, 100, 200), (100, 0.5, 100, 200), (150, 0.5, 100, 200),
                                  (200, 0.5, 100, 200), (900, 0.5, 100, 200), (150, 0.0, 100, 200),
                                  (150, 0.5, 200, 200), (150, 0.5, 300, 200)])
def test_teacher_force_prob_at(args):
    assert steps.teacher_force_prob_at(*args) == jsteps.teacher_force_prob_at(*args)


@pytest.mark.parametrize("cfg,step,bits", [
    ({}, 0, 6), ({"finebit_loss_boost_weight": 3.0}, 0, 6),
    ({"finebit_loss_boost_weight": 3.0, "finebit_boost_start_bit": 5}, 10, 6),
    ({"finebit_loss_boost_weight": 3.0, "refine_teacher_force_anneal_end": 50}, 10, 6),
    ({"finebit_loss_boost_weight": 3.0, "refine_teacher_force_anneal_end": 50}, 50, 6),
    ({"finebit_loss_boost_weight": 3.0, "finebit_boost_start_step": 5}, 10, 4),
    ({"finebit_loss_boost_weight": 3.0, "finebit_boost_start_step": 5}, 10, 5),
    ({"finebit_loss_boost_weight": None}, 10, 6)])
def test_finebit_bit_weights(cfg, step, bits):
    assert steps.finebit_bit_weights(cfg, step, bits) == jsteps.finebit_bit_weights(cfg, step,
                                                                                    bits)


def test_unported_paths_point_to_the_roadmap():
    """The NOCS step still points to the roadmap; the multi-object graph no
    longer does: a stacked (O, N, K) table gives each sample its object's
    rows (tests/test_torch_lm_multiobj.py holds the rest)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        steps.make_nocs_train_step(None, None, diameter=1.0)
    table = torch.arange(2 * NPT * KNN, dtype=torch.int32).view(2, NPT, KNN)
    got = steps.knn_for_batch(table, {"obj_idx": torch.tensor([1, 1, 0])})
    assert torch.equal(got, table[[1, 1, 0]])
    with pytest.raises(ValueError, match="bit_weights"):
        net = PoseNet(**CFG, dtype=torch.float32)
        steps.train_loss(net, None, None, {"proj_xy": torch.zeros(1, NPT, 2),
                                           "bbox": torch.ones(1, 4)}, 3, bit_weights=(1.0,))
