"""The port's backbones (models/{resnet,darknet,convnext,hrnet,backbone}.py)
against the JAX package's, f32 on the CPU with the same weights: every map
of resnet34, darknet53 and convnext_tiny, every parameter of all eight, and
PoseNet on the pyramids of three and five maps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.models import PoseNet as FlaxPoseNet
from checkerpose_tpu.models import backbone as jbackbone
from checkerpose_tpu.ops.geometry import pc_normalize
from checkerpose_tpu.ops.knn import knn_index
from checkerpose_tpu.train import steps as jsteps
from checkerpose_tpu_torch.models import backbone as tbackbone
from checkerpose_tpu_torch.models import convert
from checkerpose_tpu_torch.models.layers import init_params
from checkerpose_tpu_torch.models.posenet import PoseNet
from checkerpose_tpu_torch.ops.crop import normalize_image
from torch_parity import load_port, nchw_to_nhwc, nhwc_to_nchw, random_variables

ALL = ("resnet34", "hrnet_w18", "hrnet_w18_small", "hrnet_w30", "convnext_tiny",
       "convnext_small", "convnext_base", "darknet53")
STRIDES = {"resnet34": (4, 8, 16, 32), "darknet53": (2, 4, 8, 16, 32),
           "convnext_tiny": (8, 16, 32)}
RTOL = 1e-4          # of each map's largest magnitude; f32 on both sides


def test_registry_has_the_jax_set():
    assert tbackbone.BACKBONE_FEAT_DIMS == jbackbone.BACKBONE_FEAT_DIMS
    assert sorted(tbackbone.BACKBONE_FEAT_DIMS) == sorted(ALL)
    with pytest.raises(ValueError, match="not supported"):
        tbackbone.make_backbone("resnet50")
    with pytest.raises(ValueError, match="not supported"):
        jbackbone.make_backbone("resnet50")


@pytest.mark.parametrize("name", ALL)
def test_state_dict_matches_the_flax_tree(name, monkeypatch):
    """Every entry of the port's state_dict is a leaf of the Flax tree
    (jax.eval_shape, no compile) under flax_to_torch's naming and layout,
    and the other way round; the port's module is built on the meta
    device."""
    fmod = jbackbone.make_backbone(name, dtype=jnp.float32)
    tree = jax.eval_shape(lambda k: fmod.init(k, jnp.zeros((1, 64, 64, 3)), False),
                          jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)
    monkeypatch.setattr(convert, "_tensor", lambda v: torch.empty(v.shape, device="meta"))
    want = {k: tuple(v.shape) for k, v in convert.flax_to_torch(zeros).items()}
    with torch.device("meta"):
        net = tbackbone.make_backbone(name, dtype=torch.float32)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(7).standard_normal((2, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(STRIDES))
def test_forward_matches_jax(name, image):
    """Every map, BN statistics perturbed and ConvNeXt's gamma O(1)."""
    fmod = jbackbone.make_backbone(name, dtype=jnp.float32)
    v = random_variables(fmod, jnp.asarray(image), False, bn_scale=(0.3, 0.6), seed=3)
    ref = jax.jit(lambda v, x: fmod.apply(v, x, False))(v, jnp.asarray(image))
    net = load_port(tbackbone.make_backbone(name, dtype=torch.float32), v)
    with torch.no_grad():
        out = net(nhwc_to_nchw(image))
    dims = tbackbone.BACKBONE_FEAT_DIMS[name]
    assert len(out) == len(ref) == len(dims)
    for r, o, c, s in zip(ref, out, dims, STRIDES[name]):
        r = np.asarray(r)
        assert o.shape == (2, c, 64 // s, 64 // s) and r.shape == (2, 64 // s, 64 // s, c)
        scale = float(np.abs(r).max())
        assert 1e-2 < scale < 1e3
        np.testing.assert_allclose(nchw_to_nhwc(o), r, rtol=RTOL, atol=RTOL * scale)


def test_convnext_init_follows_flax():
    """LayerNorm scale 1 and bias 0, conv and Dense biases 0, gamma 1e-6,
    depthwise kernels lecun-normal over their 49 inputs."""
    net = tbackbone.make_backbone("convnext_tiny", dtype=torch.float32)
    init_params(net, torch.Generator().manual_seed(0))
    blk = net.stage2_block4
    np.testing.assert_array_equal(blk.gamma.detach().numpy(), np.float32(1e-6))
    np.testing.assert_array_equal(blk.norm.weight.detach().numpy(), 1.0)
    np.testing.assert_array_equal(net.down2_norm.bias.detach().numpy(), 0.0)
    for b in (blk.dwconv.bias, blk.pwconv1.bias, net.stem_conv.bias):
        np.testing.assert_array_equal(b.detach().numpy(), 0.0)
    w = blk.dwconv.weight.detach().numpy()
    assert w.shape == (384, 1, 7, 7)
    assert abs(w.std() * np.sqrt(49.0) - 1.0) < 0.05


@pytest.mark.parametrize("name", ["convnext_tiny", "darknet53"])
def test_posenet_on_other_pyramids(name):
    """Progressive refinement at res6 on a 3-map (strides 8/16/32) and a
    5-map (2-32) pyramid: the port's PoseNet against the JAX inference
    forward (as tests/test_models.py runs it on convnext_tiny)."""
    npt = 16
    rng = np.random.default_rng(0)
    p3dn = pc_normalize(rng.uniform(-30, 30, (npt, 3))).astype(np.float32)
    knn = knn_index(p3dn, 5)
    cfg = dict(npoint=npt, res_log2=6, backbone_name=name, num_graph_module=1,
               init_num_graph_module=1)
    fnet = FlaxPoseNet(**cfg, dtype=jnp.float32)
    v = random_variables(fnet, jnp.zeros((1, 256, 256, 3)), knn, jnp.zeros((1, npt, 3)),
                         stage=3, train=False, bn_scale=(0.3, 0.6))
    batch = {"image": rng.integers(0, 255, (1, 256, 256, 3)).astype(np.uint8),
             "p3d_normed": p3dn[None]}
    ref = {k: np.asarray(x) for k, x in
           jsteps.make_pose_forward(fnet, knn, stage=3)(v, batch).items()}
    net = load_port(PoseNet(**cfg, dtype=torch.float32), v)
    with torch.no_grad():
        out = net(normalize_image(torch.from_numpy(batch["image"])), torch.from_numpy(knn),
                  stage=3)
    assert out["x_logits"].shape == (1, npt, 6) and out["seg_logits"].shape == (1, 64, 64, 2)
    for k in ("x_id", "y_id"):
        assert (out[k].numpy() == ref[k]).mean() > 0.9, k
    np.testing.assert_allclose(out["x_logits"][..., :3].numpy(), ref["x_logits"][..., :3],
                               atol=1e-3)
    seg = torch.sigmoid(out["seg_logits"]).numpy()
    np.testing.assert_allclose(seg[..., 0], ref["seg_visib"], atol=2e-2)
