"""timm / torchvision checkpoints into the port (models/convert.py:
load_torch_state_dict, convert_resnet34, convert_hrnet_w18) against the JAX
package's converters followed by flax_to_torch, on hand-written timm
layouts; and the Flax <-> port rules of ConvNeXt's LayerNorm and layer
scale, Adam state included."""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from checkerpose_tpu.models import convert as jconvert
from checkerpose_tpu.models.convnext import ConvNeXtBlock as FlaxConvNeXtBlock
from checkerpose_tpu_torch.models import convert
from checkerpose_tpu_torch.models.convnext import ConvNeXtBlock
from checkerpose_tpu_torch.models.init_net import InitNet
from checkerpose_tpu_torch.models.layers import LayerNorm
from test_convert import _fake_torch_resnet34_sd
from test_convert_hrnet import _fake_timm_hrnet_w18_sd
from torch_parity import load_port, nchw_to_nhwc, nhwc_to_nchw, random_variables

FAKES = {"resnet34": _fake_torch_resnet34_sd, "hrnet_w18": _fake_timm_hrnet_w18_sd}
# entries a real checkpoint carries that no backbone leaf takes
EXTRA = {"resnet34": ("fc.weight", "fc.bias", "layer1.0.bn1.num_batches_tracked"),
         "hrnet_w18": ("classifier.weight", "final_layer.0.weight",
                       "downsamp_modules.0.0.weight", "bn1.num_batches_tracked")}


def _timm_sd(name, seed):
    sd = FAKES[name](np.random.default_rng(seed))
    for k in EXTRA[name]:
        sd[k] = np.ones(3, np.int64 if k.endswith("tracked") else np.float32)
    return sd


@pytest.mark.parametrize("name", sorted(FAKES))
def test_converter_matches_jax_bit_for_bit(name):
    sd = _timm_sd(name, 0)
    params, stats = jconvert.CONVERTERS[name](sd)
    want = convert.flax_to_torch({"params": params, "batch_stats": stats})
    got = convert.CONVERTERS[name]({k: torch.from_numpy(v) for k, v in sd.items()})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    # numpy input converts the same
    got_np = convert.CONVERTERS[name](sd)
    assert all(torch.equal(got_np[k], v) for k, v in want.items())
    assert sorted(convert.CONVERTERS) == sorted(jconvert.CONVERTERS)


@pytest.mark.parametrize("name", sorted(FAKES))
def test_graft_into_an_init_net(name):
    """Every backbone entry of an InitNet of that backbone is set, no
    converted key is unknown, and the features are finite."""
    conv = convert.CONVERTERS[name](_timm_sd(name, 1))
    net = InitNet(npoint=16, res_log2=3, backbone_name=name, num_graph_module=1,
                  dtype=torch.float32)
    own = {k[len("backbone."):] for k in net.state_dict() if k.startswith("backbone.")}
    assert set(conv) == own
    net.load_state_dict(convert.graft_backbone(net.state_dict(), conv, into=""))
    after = net.state_dict()
    for k, v in conv.items():
        assert torch.equal(after["backbone." + k], v), k
    bad = dict(conv, **{"stem_extra.weight": torch.zeros(1)})
    with pytest.raises(KeyError):
        convert.graft_backbone(net.state_dict(), bad, into="")


@pytest.mark.parametrize("name", sorted(FAKES))
def test_chip_smoke_layouts_are_timm_layouts(name):
    """chip_smoke.py writes its timm state_dicts by hand too: the same
    entries and shapes as the JAX package's test layouts."""
    ours = chip_smoke.timm_state_dict(name, np.random.default_rng(0))
    theirs = FAKES[name](np.random.default_rng(0))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
    assert all((v > 0).all() for k, v in ours.items() if k.endswith("running_var"))


@pytest.mark.parametrize("wrap", [None, "state_dict", "model_state_dict"])
def test_load_torch_state_dict(tmp_path, wrap):
    """Tensors only, unwrapped as the JAX package's loader does; a file of
    `torch.save` with plain objects beside the tensors loads."""
    sd = {"conv1.weight": torch.randn(4, 3, 3, 3), "bn1.running_var": torch.rand(4) + 0.5,
          "bn1.num_batches_tracked": torch.tensor(7), "note": "imagenet", "epoch": 90}
    payload = sd if wrap is None else {wrap: sd, "epoch": 90, "arch": "resnet34"}
    path = str(tmp_path / "ckpt.pth")
    torch.save(payload, path)
    got = convert.load_torch_state_dict(path)
    want = jconvert.load_torch_state_dict(path)
    assert sorted(got) == sorted(want) == ["bn1.num_batches_tracked", "bn1.running_var",
                                           "conv1.weight"]
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_convnext_leaves_both_ways():
    """LayerNorm scale <-> weight (a rank-1 weight without running
    statistics), gamma <-> gamma, the depthwise kernel (7, 7, 1, C) <->
    (C, 1, 7, 7); the block's forward agrees with Flax's."""
    dim = 8
    x = np.random.default_rng(0).standard_normal((2, 9, 9, dim)).astype(np.float32)
    fblk = FlaxConvNeXtBlock(dim, dtype=jnp.float32)
    v = random_variables(fblk, jnp.asarray(x))
    sd = convert.flax_to_torch(v)
    assert sd["dwconv.weight"].shape == (dim, 1, 7, 7) and sd["gamma"].shape == (dim,)
    assert sorted(sd) == sorted(ConvNeXtBlock(dim, dtype=torch.float32).state_dict())
    blk = load_port(ConvNeXtBlock(dim, dtype=torch.float32), v)
    with torch.no_grad():
        out = nchw_to_nhwc(blk(nhwc_to_nchw(x)))
    np.testing.assert_allclose(out, np.asarray(fblk.apply(v, jnp.asarray(x))), atol=1e-5,
                               rtol=1e-5)
    back = convert.torch_to_flax(blk.state_dict())
    assert back["batch_stats"] == {}
    flat = dict(_leaves(v["params"]))
    assert dict(_leaves(back["params"])).keys() == flat.keys()
    for path, leaf in _leaves(back["params"]):
        np.testing.assert_array_equal(leaf, flat[path], err_msg="/".join(path))


def test_convnext_adam_state_both_ways():
    """optax-layout Adam moments of a ConvNeXt block -> torch.optim.Adam ->
    back, the LayerNorm's moments under `scale` and the layer scale's under
    `gamma`."""
    holder = torch.nn.Module()
    holder.blk, holder.norm = ConvNeXtBlock(8, dtype=torch.float32), LayerNorm(6)
    opt = torch.optim.Adam(holder.parameters(), lr=1e-3)
    rng = np.random.default_rng(1)
    fparams = convert.torch_to_flax(holder.state_dict())["params"]
    mu = {p: rng.standard_normal(a.shape).astype(np.float32) for p, a in _leaves(fparams)}
    nu = {p: rng.uniform(0, 1, a.shape).astype(np.float32) for p, a in _leaves(fparams)}
    convert.adam_state_to_torch(holder, opt, 3, _tree(mu), _tree(nu))
    count, mu2, nu2 = convert.adam_state_to_flax(holder, opt)
    assert count == 3
    assert ("norm", "scale") in mu and ("blk", "gamma") in mu and ("blk", "norm", "scale") in mu
    for want, got in ((mu, mu2), (nu, nu2)):
        got = dict(_leaves(got))
        assert got.keys() == want.keys()
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg="/".join(p))


def test_layernorm_matches_flax_on_bf16_input():
    """f32 statistics with the fast variance on a bf16 input, over the
    channels of an NCHW map."""
    x = (np.random.default_rng(2).standard_normal((2, 5, 5, 12)) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    fln = nn.LayerNorm(epsilon=1e-6, dtype=jnp.float32)
    v = random_variables(fln, xb)
    ref = np.asarray(fln.apply(v, xb))
    ln = LayerNorm(12)
    ln.load_state_dict(convert.flax_to_torch(v))
    with torch.no_grad():
        out = ln(nhwc_to_nchw(np.array(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(nchw_to_nhwc(out), ref, atol=1e-5, rtol=1e-5)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _tree(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out
