"""Port PoseNet forward vs the JAX inference forward
(train/steps.py::make_pose_forward), f32 on CPU, same weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.models import PoseNet as FlaxPoseNet
from checkerpose_tpu.ops.geometry import pc_normalize
from checkerpose_tpu.ops.knn import knn_index
from checkerpose_tpu.train import steps
from checkerpose_tpu_torch.models.posenet import PoseNet, _hard_ids
from checkerpose_tpu_torch.ops.crop import normalize_image
from torch_parity import load_port, random_variables

NPT, CROP, BATCH = 16, 256, 2
CFG = dict(npoint=NPT, res_log2=6, backbone_name="hrnet_w18_small", num_graph_module=3,
           init_num_graph_module=2, local_k=2)


@pytest.fixture(scope="module")
def outputs():
    rng = np.random.default_rng(0)
    p3d = rng.uniform(-30, 30, (NPT, 3)).astype(np.float32)
    p3dn = pc_normalize(p3d).astype(np.float32)
    knn = knn_index(p3dn, 5)
    fnet = FlaxPoseNet(**CFG, dtype=jnp.float32)
    # BN scales below 1 keep the deep backbone's activations O(1)
    variables = random_variables(fnet, jnp.zeros((1, CROP, CROP, 3)), knn,
                                 jnp.zeros((1, NPT, 3)), stage=3, train=False,
                                 bn_scale=(0.3, 0.6))
    batch = {"image": rng.integers(0, 255, (BATCH, CROP, CROP, 3)).astype(np.uint8),
             "p3d_normed": np.tile(p3dn[None], (BATCH, 1, 1))}
    ref = {k: np.asarray(v) for k, v in
           steps.make_pose_forward(fnet, knn, stage=3)(variables, batch).items()}
    net = load_port(PoseNet(**CFG, dtype=torch.float32), variables)
    with torch.no_grad():
        imgs = normalize_image(torch.from_numpy(batch["image"]))
        out = net(imgs, torch.from_numpy(knn), stage=3)
    return ref, {k: v.numpy() for k, v in out.items()}


def test_ids_agree(outputs):
    ref, out = outputs
    # hard ids agree except where a logit sits within f32 noise of 0
    for k in ("x_id", "y_id"):
        assert out[k].shape == ref[k].shape == (BATCH, NPT)
        assert out[k].dtype == np.int32
        assert (out[k] == ref[k]).mean() > 0.95, k
    roi = (out["roi_logit"][..., 0] > 0).astype(np.float32)
    assert (roi == ref["roi_mask"]).mean() > 0.95


def test_seg_agrees(outputs):
    ref, out = outputs
    seg = 1.0 / (1.0 + np.exp(-out["seg_logits"]))
    assert seg.shape == (BATCH, 64, 64, 2)
    np.testing.assert_allclose(seg[..., 0], ref["seg_visib"], atol=2e-2)
    np.testing.assert_allclose(seg[..., 1], ref["seg_full"], atol=2e-2)


def test_logits_agree(outputs):
    """Init-net bits everywhere, and every refine bit of keypoints whose
    ids agree at every stage (a different cell gathers other features):
    atol 1e-3 (f32, logits O(1))."""
    ref, out = outputs
    for k in ("x_logits", "y_logits"):
        assert out[k].shape == (BATCH, NPT, 6)
        np.testing.assert_allclose(out[k][..., :3], ref[k][..., :3], atol=1e-3)
    same = (out["x_id"] == ref["x_id"]) & (out["y_id"] == ref["y_id"])
    assert same.any()
    for k in ("x_logits", "y_logits"):
        np.testing.assert_allclose(out[k][same], ref[k][same], atol=1e-3)


def test_ids_follow_logits(outputs):
    """x_id = MSB-first bits of the logits (x_id = 2 x_id + bit per stage)."""
    _, out = outputs
    ids = _hard_ids(torch.from_numpy(out["x_logits"])).numpy()
    np.testing.assert_array_equal(ids, out["x_id"])


def test_forward_refuses_train_and_bad_stage():
    """Train mode is no longer refused: it runs, returns the init net's
    response maps beside the usual outputs and moves the BatchNorm
    statistics. A stage outside [1, 3] is still refused."""
    net = PoseNet(**CFG, dtype=torch.float32).train()
    img = torch.zeros(2, CROP, CROP, 3)
    knn = torch.arange(NPT, dtype=torch.int32)[:, None].expand(NPT, 5).contiguous()
    var0 = net.up_0.bn1.running_var.clone()
    out = net(img, knn, stage=1)
    assert out["x_logits"].shape == (2, NPT, 4) and out["resp_map"].shape == (2, NPT, 64)
    assert out["x_logits"].requires_grad
    assert not torch.equal(net.up_0.bn1.running_var, var0)
    with pytest.raises(TypeError):
        net(img, knn, train=True)          # the mode is the module's, not an argument
    with pytest.raises(ValueError):
        net.eval()(img, knn, stage=4)
