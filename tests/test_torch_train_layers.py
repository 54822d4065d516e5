"""Train mode of the port's BatchNorm and EdgeConv vs Flax (`train=True`),
f32 on the CPU, same numpy inputs and weights; and the EdgeConv fold cache
across training."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkerpose_tpu.models.graph import EdgeConv as FlaxEdgeConv
from checkerpose_tpu.ops.knn import knn_index
from checkerpose_tpu_torch.models.convert import flax_to_torch
from checkerpose_tpu_torch.models.graph import EdgeConv
from checkerpose_tpu_torch.models.layers import BatchNorm
from torch_parity import few_torch_threads, random_variables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

B, N, K, C, CP = 3, 24, 5, 16, 12


def _flax_bn():
    return fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                         dtype=jnp.float32)


@pytest.mark.parametrize("shape,channel_dim", [((4, 6, 5, 7), 1), ((3, 10, 4, 7), -1)],
                         ids=["nchw", "edge_tensor_channel_last"])
def test_batchnorm_train_matches_flax(shape, channel_dim):
    """Output and running mean/var after one and after two calls: 1e-5.
    The running variance is the biased one (torch's own BN would store the
    unbiased one: with 120 samples a channel that differs by 0.8%, far above
    the bar)."""
    rng = np.random.default_rng(0)
    xs = [(2.0 * rng.standard_normal(shape) + 1.5).astype(np.float32) for _ in range(2)]
    nc = shape[channel_dim]
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, nc).astype(np.float32),
                            "bias": rng.standard_normal(nc).astype(np.float32)},
                 "batch_stats": {"mean": rng.standard_normal(nc).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, nc).astype(np.float32)}}
    bn = BatchNorm(nc).train()
    bn.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                        "bias": torch.from_numpy(variables["params"]["bias"]),
                        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(variables["batch_stats"]["var"])})
    for x in xs:
        # Flax normalises the last axis: move the channel there and back
        xj = jnp.moveaxis(jnp.asarray(x), channel_dim, -1)
        ref, upd = _flax_bn().apply(variables, xj, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        out = bn(torch.from_numpy(x), channel_dim=channel_dim)
        assert out.dtype == torch.float32 and out.requires_grad
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.moveaxis(np.asarray(ref), -1, channel_dim),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-5)
    assert not bn.running_mean.requires_grad


def test_batchnorm_bf16_input_takes_f32_statistics():
    x = torch.randn(4, 8, 6, 6, generator=torch.Generator().manual_seed(0)).bfloat16()
    bn = BatchNorm(8).train()
    out = bn(x)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * x.float().mean((0, 2, 3)).numpy(), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def edge():
    rng = np.random.default_rng(1)
    knn = knn_index(rng.standard_normal((N, 3)), K)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    cot = rng.standard_normal((B, N, CP)).astype(np.float32)
    fmod = FlaxEdgeConv(CP, 0.2, dtype=jnp.float32)
    variables = random_variables(fmod, jnp.asarray(x), knn, False, seed=1)

    def loss(params, x):
        out, upd = fmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              x, knn, True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (out, stats)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    mod = EdgeConv(C, CP, 0.2, dtype=torch.float32)
    mod.load_state_dict(flax_to_torch(variables))
    return dict(knn=knn, x=x, cot=cot, variables=variables, out=np.asarray(out),
                stats=jax.tree.map(np.asarray, stats),
                g_params=jax.tree.map(np.asarray, g_params), g_x=np.asarray(g_x), mod=mod)


def test_edgeconv_train_matches_flax(edge):
    """Output 1e-4; gradients w.r.t. x, the Dense kernel and BN's scale and
    bias 1e-4 of the leaf's largest entry; new running statistics 1e-5."""
    mod = edge["mod"].train()
    xt = torch.from_numpy(edge["x"]).requires_grad_()
    out = mod(xt, torch.from_numpy(edge["knn"]))
    np.testing.assert_allclose(out.detach().numpy(), edge["out"], rtol=1e-4, atol=1e-4)
    (out * torch.from_numpy(edge["cot"])).sum().backward()
    pairs = {"x": (xt.grad.numpy(), edge["g_x"]),
             "kernel": (mod.conv.weight.grad.numpy().T, edge["g_params"]["conv"]["kernel"]),
             "bn.scale": (mod.bn.weight.grad.numpy(), edge["g_params"]["bn"]["scale"]),
             "bn.bias": (mod.bn.bias.grad.numpy(), edge["g_params"]["bn"]["bias"])}
    for name, (got, want) in pairs.items():
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_allclose(mod.bn.running_mean.numpy(), edge["stats"]["bn"]["mean"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.bn.running_var.numpy(), edge["stats"]["bn"]["var"],
                               rtol=1e-5, atol=1e-5)


def test_fold_cache_sees_training():
    """Two train steps (an optimizer's in-place writes and BN's in-place
    running-stat updates), then eval and forward: the weights were folded
    once more, exactly once over two eval forwards, and the output equals
    that of a freshly built module loaded with the same state_dict."""
    g = torch.Generator().manual_seed(0)
    knn = torch.from_numpy(knn_index(torch.randn(N, 3, generator=g).numpy(), K))
    x = torch.randn(B, N, C, generator=g)
    mod = EdgeConv(C, CP, dtype=torch.float32).eval()
    before = mod(x, knn)
    assert mod.folds == 1
    opt = torch.optim.Adam(mod.parameters(), lr=1e-2)
    mod.train()
    for _ in range(2):
        opt.zero_grad()
        mod(x, knn).square().mean().backward()
        opt.step()
    assert mod.folds == 1                         # train mode folds nothing
    mod.eval()
    with torch.no_grad():
        after = mod(x, knn)
        again = mod(x, knn)
    assert mod.folds == 2
    assert torch.equal(after, again) and not torch.equal(after, before)
    fresh = EdgeConv(C, CP, dtype=torch.float32).eval()
    fresh.load_state_dict(mod.state_dict())
    with torch.no_grad():
        assert torch.equal(fresh(x, knn), after)


def test_fold_cache_sees_an_optimizer_step_in_eval_mode():
    """The key holds each tensor's version counter: an optimizer step and a
    running-stat write bump it even when no train()/eval() call comes
    between (foreach and plain Adam alike)."""
    g = torch.Generator().manual_seed(1)
    knn = torch.from_numpy(knn_index(torch.randn(N, 3, generator=g).numpy(), K))
    x = torch.randn(B, N, C, generator=g)
    for foreach in (False, True):
        mod = EdgeConv(C, CP, dtype=torch.float32).eval()
        opt = torch.optim.Adam(mod.parameters(), lr=1e-2, foreach=foreach)
        with torch.no_grad():
            mod(x, knn)
        for p in mod.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        with torch.no_grad():
            mod(x, knn)
        assert mod.folds == 2, foreach
        with torch.no_grad():
            mod.bn.running_var.mul_(0.9)
            mod(x, knn)
        assert mod.folds == 3, foreach
