"""The multi-object (LM) model path of the port against the JAX package's
(mirrors tests/test_lm_multiobj.py), hrnet_w18_small, 16 keypoints, K=5, 3
objects, on the CPU, same numpy inputs and weights (models/convert.py):

  * `knn_for_batch`: rows of the stacked table, exactly; a static graph
    passes through as the same object;
  * EdgeConv on a per-sample (B, N, K) graph vs Flax's `EdgeConv` on the
    same index: eval forward in f32 1e-5, in bf16 1e-2 + 2^-7 |ref|; train
    forward and new running statistics 1e-5; gradients by relative L2 1e-4;
    with every row the same graph, the per-sample eval path equals the
    static plain path (`edgeconv_fused_plain`) to 1e-5 in f32;
  * the pretrain and train steps on a batch of mixed obj_idx: loss terms
    1e-4, gradients and running statistics as tests/test_torch_train_steps.py
    holds them;
  * `PoseNetWoProg`: forward at stage 3 (ids exact, logits 1e-4), its
    shapes, and a `full_bits` train step;
  * the config-level ablations `num_graph_module=0` (`_woEdgeConv`) and
    `init_num_graph_module=0` (`init_gnn0`): forward parity with Flax's
    PoseNet.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.models import InitNet as FlaxInitNet
from checkerpose_tpu.models import PoseNet as FlaxPoseNet
from checkerpose_tpu.models.ablation import PoseNetWoProg as FlaxWoProg
from checkerpose_tpu.models.graph import EdgeConv as FlaxEdgeConv
from checkerpose_tpu.ops.geometry import pc_normalize
from checkerpose_tpu.ops.knn import knn_index
from checkerpose_tpu.train import steps as jsteps
from checkerpose_tpu_torch.models.ablation import PoseNetWoProg
from checkerpose_tpu_torch.models.convert import flax_to_torch
from checkerpose_tpu_torch.models.graph import EdgeConv
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.posenet import PoseNet
from checkerpose_tpu_torch.ops.edgeconv import (edgeconv_eval_per_sample, edgeconv_fused_plain,
                                                reset_launch_counts)
from checkerpose_tpu_torch.train import steps
from test_torch_train_steps import _check_grads, _check_stats, _jax_step
from torch_parity import few_torch_threads, random_variables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

NPT, K, NOBJ, CROP, BATCH = 16, 5, 3, 256, 3
OBJ_IDX = np.array([2, 0, 1], np.int32)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(npoint=NPT, res_log2=6, backbone_name="hrnet_w18_small", num_graph_module=1,
             init_num_graph_module=1)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(0)
    p3d = rng.uniform(-30, 30, (NOBJ, NPT, 3)).astype(np.float32)
    normed = np.stack([pc_normalize(p.astype(np.float64)).astype(np.float32) for p in p3d])
    knn = np.stack([knn_index(n, K) for n in normed])
    return p3d, normed, knn


def _batch(rng, crop_gt=64):
    return {
        "image": rng.integers(0, 255, (BATCH, CROP, CROP, 3)).astype(np.uint8),
        "proj_xy": np.stack([rng.uniform(60, 170, (BATCH, NPT)),
                             rng.uniform(70, 180, (BATCH, NPT))], -1).astype(np.float32),
        "bbox": np.tile(np.array([50, 60, 130, 130], np.float32), (BATCH, 1)),
        "mask_visib": (rng.random((BATCH, crop_gt, crop_gt)) > 0.5).astype(np.float32),
        "mask_full": (rng.random((BATCH, crop_gt, crop_gt)) > 0.3).astype(np.float32),
        "obj_idx": OBJ_IDX.copy(),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _imgs(batch):
    return steps.device_augment_normalize(torch.from_numpy(batch["image"]), None, False, False,
                                          train=False)


def test_knn_for_batch_gathers(tables):
    knn = torch.from_numpy(tables[2])
    batch = {"obj_idx": torch.tensor([2, 0], dtype=torch.int32)}
    out = steps.knn_for_batch(knn, batch)
    ref = np.asarray(jsteps.knn_for_batch(tables[2], {"obj_idx": jnp.asarray([2, 0])}))
    assert out.shape == (2, NPT, K) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out[0].numpy(), tables[2][2])
    single = knn[0]
    assert steps.knn_for_batch(single, batch) is single
    with pytest.raises(ValueError):
        steps.knn_for_batch(knn[None], batch)


# --- EdgeConv on a per-sample graph ----------------------------------------------------

EB, EN, EC, ECP = 3, 24, 16, 12


@pytest.fixture(scope="module")
def edge():
    rng = np.random.default_rng(1)
    graphs = np.stack([knn_index(rng.standard_normal((EN, 3)), K) for _ in range(NOBJ)])
    idx = graphs[OBJ_IDX]                                      # (B, N, K)
    x = rng.standard_normal((EB, EN, EC)).astype(np.float32)
    cot = rng.standard_normal((EB, EN, ECP)).astype(np.float32)
    fmod = FlaxEdgeConv(ECP, 0.2, dtype=jnp.float32)
    variables = random_variables(fmod, jnp.asarray(x), jnp.asarray(idx), False, seed=1)

    def loss(params, x):
        out, upd = fmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              x, jnp.asarray(idx), True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (out, stats)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    return dict(idx=idx, graphs=graphs, x=x, cot=cot, fmod=fmod, variables=variables,
                out=np.asarray(out), stats=jax.tree.map(np.asarray, stats),
                g_params=jax.tree.map(np.asarray, g_params), g_x=np.asarray(g_x))


def _port_edgeconv(edge, dtype=torch.float32):
    mod = EdgeConv(EC, ECP, 0.2, dtype=dtype)
    mod.load_state_dict(flax_to_torch(edge["variables"]))
    return mod


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_per_sample_edgeconv_eval_matches_flax(edge):
    """f32 1e-5 through the per-sample path (counted; no fold, no kernel
    route); bf16 1e-2 + 2^-7 |ref|."""
    ref = np.asarray(edge["fmod"].apply(edge["variables"], jnp.asarray(edge["x"]),
                                        jnp.asarray(edge["idx"]), False))
    mod = _port_edgeconv(edge).eval()
    reset_launch_counts()
    with torch.no_grad():
        out = mod(torch.from_numpy(edge["x"]), torch.from_numpy(edge["idx"]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert edgeconv_eval_per_sample.calls == 1 and mod.folds == 0
    assert mod._fused_cache is None

    fb = edge["fmod"].clone(dtype=jnp.bfloat16)
    ref16 = np.asarray(fb.apply(edge["variables"], jnp.asarray(edge["x"]),
                                jnp.asarray(edge["idx"]), False), np.float32)
    mod16 = _port_edgeconv(edge, torch.bfloat16).eval()
    with torch.no_grad():
        out16 = mod16(torch.from_numpy(edge["x"]), torch.from_numpy(edge["idx"]))
    assert out16.dtype == torch.bfloat16
    err = np.abs(out16.float().numpy() - ref16)
    assert (err <= 1e-2 + 2.0 ** -7 * np.abs(ref16)).all(), err.max()


def test_per_sample_edgeconv_train_matches_flax(edge):
    """Train forward and new running statistics 1e-5; gradients w.r.t. x,
    the Dense kernel and BN's scale and bias by relative L2 1e-4 (the
    backward of the gather is a scatter-add on both sides)."""
    mod = _port_edgeconv(edge).train()
    xt = torch.from_numpy(edge["x"]).requires_grad_()
    out = mod(xt, torch.from_numpy(edge["idx"]))
    np.testing.assert_allclose(out.detach().numpy(), edge["out"], rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(edge["cot"])).sum().backward()
    pairs = {"x": (xt.grad.numpy(), edge["g_x"]),
             "kernel": (mod.conv.weight.grad.numpy().T, edge["g_params"]["conv"]["kernel"]),
             "bn.scale": (mod.bn.weight.grad.numpy(), edge["g_params"]["bn"]["scale"]),
             "bn.bias": (mod.bn.bias.grad.numpy(), edge["g_params"]["bn"]["bias"])}
    for name, (got, want) in pairs.items():
        assert _rel_l2(got, want) <= 1e-4, name
    for stat, buf in (("mean", mod.bn.running_mean), ("var", mod.bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), edge["stats"]["bn"][stat], rtol=1e-5, atol=1e-5)
    assert mod.folds == 0


def test_per_sample_path_with_equal_rows_is_the_static_path(edge):
    """All rows the same graph: the per-sample eval path equals the static
    plain version on it, f32 1e-5."""
    mod = _port_edgeconv(edge).eval()
    static = torch.from_numpy(edge["graphs"][1])
    x = torch.from_numpy(edge["x"])
    w1, w2m1 = mod.split_weights()
    scale, bias = mod.bn.folded()
    with torch.no_grad():
        got = edgeconv_eval_per_sample(x, static[None].expand(EB, EN, K), w1, w2m1, mod.bn)
        want = edgeconv_fused_plain(x, static, w1, w2m1, scale, bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        edgeconv_eval_per_sample(x, static, w1, w2m1, mod.bn)
    with pytest.raises(RuntimeError, match="eval mode"):
        edgeconv_eval_per_sample(x, static[None].expand(EB, EN, K), w1, w2m1,
                                 mod.bn.train())


# --- the steps on a batch of mixed obj_idx --------------------------------------------------


def test_multiobj_pretrain_step_matches_jax(tables):
    _, _, knn = tables
    cfg = dict(npoint=NPT, res_log2=3, backbone_name="hrnet_w18_small", num_graph_module=1)
    fnet = FlaxInitNet(**cfg, dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, CROP, CROP, 3)), knn[0], False,
                                 bn_scale=(0.3, 0.6), seed=2)
    batch = _batch(np.random.default_rng(2))
    grads, metrics, new_stats = _jax_step(
        lambda opt: jsteps.make_pretrain_step(fnet, knn, opt, crop_size_gt=128,
                                              color_aug_prob=0.0),
        variables, batch, jax.random.PRNGKey(0))
    net = InitNet(**cfg, dtype=torch.float32)
    net.load_state_dict(flax_to_torch(variables), strict=True)
    total, got = steps.pretrain_loss(net.train(), torch.from_numpy(knn), _imgs(batch),
                                     _torch_batch(batch), 128)
    assert sorted(got) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k].detach()), v, err_msg=k, **LOSS_TOL)
    total.backward()
    _check_grads(net, grads, variables)
    _check_stats(net, new_stats)


def test_multiobj_train_step_matches_jax(tables):
    _, normed, knn = tables
    cfg = dict(SMALL, num_graph_module=2)
    fnet = FlaxPoseNet(**cfg, dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, CROP, CROP, 3)), knn[0],
                                 jnp.zeros((1, NPT, 3)), stage=3, train=False,
                                 bn_scale=(0.3, 0.6), seed=3)
    batch = _batch(np.random.default_rng(3))
    batch["p3d_normed"] = normed[batch["obj_idx"]]
    grads, metrics, new_stats = _jax_step(
        lambda opt: jsteps.make_train_step(fnet, knn, opt, stage=3, color_aug_prob=0.0),
        variables, batch, jax.random.PRNGKey(1))
    net = PoseNet(**cfg, dtype=torch.float32)
    net.load_state_dict(flax_to_torch(variables), strict=True)
    total, got = steps.train_loss(net.train(), torch.from_numpy(knn), _imgs(batch),
                                  _torch_batch(batch), 3)
    assert sorted(got) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k].detach()), v, err_msg=k, **LOSS_TOL)
    total.backward()
    _check_grads(net, grads, variables)
    _check_stats(net, new_stats)


# --- the woProg ablation ------------------------------------------------------------------


@pytest.fixture(scope="module")
def woprog(tables):
    _, normed, knn = tables
    fnet = FlaxWoProg(**SMALL, dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, CROP, CROP, 3)), knn[0], stage=3,
                                 train=False, bn_scale=(0.3, 0.6), seed=4)
    net = PoseNetWoProg(**SMALL, dtype=torch.float32)
    net.load_state_dict(flax_to_torch(variables), strict=True)
    return dict(fnet=fnet, variables=variables, net=net, knn=knn, normed=normed)


def test_woprog_forward_matches_flax(woprog):
    """Stage 3 on the per-sample graph: logits and seg 1e-4, ids exact; ids
    at full resolution (< 64) with res_log2 bits at every stage."""
    s = woprog
    batch = _batch(np.random.default_rng(5))
    imgs = _imgs(batch)
    knn_b = s["knn"][batch["obj_idx"]]
    ref = s["fnet"].apply(s["variables"], jnp.asarray(imgs.numpy()), jnp.asarray(knn_b),
                          stage=3, train=False)
    net = s["net"].eval()
    with torch.no_grad():
        out = net(imgs, torch.from_numpy(knn_b), stage=3)
    assert out["x_logits"].shape == (BATCH, NPT, 6) and out["seg_logits"].shape == (BATCH, 64,
                                                                                      64, 2)
    for k in ("roi_logit", "x_logits", "y_logits", "seg_logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("x_id", "y_id"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
        assert int(out[k].max()) < 64
    assert net.output_res_log2(1) == 6 and net.num_refine_steps == 3
    with torch.no_grad():
        one = net(imgs, torch.from_numpy(knn_b), stage=1)
    assert one["x_logits"].shape == (BATCH, NPT, 6) and one["seg_logits"].shape[1] == 16
    with pytest.raises(ValueError):
        net(imgs, torch.from_numpy(knn_b), stage=4)


def test_woprog_full_bits_train_step_matches_jax(woprog):
    s = woprog
    batch = _batch(np.random.default_rng(6))
    batch["p3d_normed"] = s["normed"][batch["obj_idx"]]
    grads, metrics, new_stats = _jax_step(
        lambda opt: jsteps.make_train_step(s["fnet"], s["knn"], opt, stage=3, full_bits=True,
                                           color_aug_prob=0.0),
        s["variables"], batch, jax.random.PRNGKey(2))
    net = PoseNetWoProg(**SMALL, dtype=torch.float32)
    net.load_state_dict(flax_to_torch(s["variables"]), strict=True)
    total, got = steps.train_loss(net.train(), torch.from_numpy(s["knn"]), _imgs(batch),
                                  _torch_batch(batch), 3, full_bits=True)
    assert sorted(got) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k].detach()), v, err_msg=k, **LOSS_TOL)
    total.backward()
    _check_grads(net, grads, s["variables"])
    _check_stats(net, new_stats)


# --- config-level ablations ---------------------------------------------------------------


@pytest.mark.parametrize("ablation", [dict(num_graph_module=0), dict(init_num_graph_module=0)],
                         ids=["woEdgeConv", "init_gnn0"])
def test_graph_module_ablations_match_flax(tables, ablation):
    """PoseNet with no EdgeConv in the refine stages (`_woEdgeConv`) or in
    the init net (`init_gnn0`): logits and seg 1e-4 at stage 3 on a
    per-sample graph, the ids on at least 95% of keypoints."""
    _, _, knn = tables
    cfg = dict(SMALL, **ablation)
    fnet = FlaxPoseNet(**cfg, dtype=jnp.float32)
    variables = random_variables(fnet, jnp.zeros((1, CROP, CROP, 3)), knn[0],
                                 jnp.zeros((1, NPT, 3)), stage=3, train=False,
                                 bn_scale=(0.3, 0.6), seed=7)
    batch = _batch(np.random.default_rng(7))
    imgs = _imgs(batch)
    knn_b = knn[batch["obj_idx"]]
    ref = fnet.apply(variables, jnp.asarray(imgs.numpy()), jnp.asarray(knn_b), None, stage=3,
                     train=False)
    net = PoseNet(**cfg, dtype=torch.float32)
    net.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        out = net.eval()(imgs, torch.from_numpy(knn_b), stage=3)
    n_conv = sum(isinstance(m, EdgeConv) for m in net.modules())
    assert n_conv == cfg["init_num_graph_module"] + 3 * cfg["num_graph_module"]
    for k in ("roi_logit", "x_logits", "y_logits", "seg_logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("x_id", "y_id"):
        assert (out[k].numpy() == np.asarray(ref[k])).mean() >= 0.95, k
