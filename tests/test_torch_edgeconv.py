"""Fused EdgeConv of the port (ops/edgeconv.py, models/graph.py) vs the JAX
Pallas kernel (interpret mode), its XLA reference and Flax EdgeConv.

The card tests (marker `gpu`) need neither the JAX package nor Flax, so the
JAX-side imports sit inside the tests that use them: on a machine without
Flax, `python -m pytest -m gpu tests/test_torch_edgeconv.py` still collects.
"""
import numpy as np
import pytest
import torch

from checkerpose_tpu_torch.models.graph import EdgeConv
from checkerpose_tpu_torch.ops.edgeconv import (
    MAX_SMEM, _launch, edgeconv_fused, edgeconv_fused_plain, edgeconv_route, fma_smem_bytes,
    pack_edgeconv_weights, tc_smem_bytes, tc_stages, unpack_edgeconv_weights)
from checkerpose_tpu_torch.ops.knn import knn_index
from torch_parity import load_port, random_variables, require_cuda

# the shapes and bar of tests/test_pallas_edgeconv.py
B, N, C, CP, K = 2, 128, 64, 64, 10
TOL = 2e-3


def _inputs(seed=0, C=C, Cp=CP):
    rng = np.random.default_rng(seed)
    knn = knn_index(rng.standard_normal((N, 3)).astype(np.float32), K)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    kernel = (rng.standard_normal((2 * C, Cp)) * 0.1).astype(np.float32)
    g = rng.standard_normal(Cp).astype(np.float32)      # mixed signs: max and min branch
    b = rng.standard_normal(Cp).astype(np.float32)
    m = rng.standard_normal(Cp).astype(np.float32) * 0.1
    v = (np.abs(rng.standard_normal(Cp)) + 0.5).astype(np.float32)
    return knn, x, kernel, g, b, m, v


def _folded(kernel, g, b, m, v, dtype=torch.float32):
    Cin = kernel.shape[0] // 2
    s = g / np.sqrt(v + 1e-5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(kernel[:Cin]).to(dtype), t(kernel[Cin:] - kernel[:Cin]).to(dtype),
            t(s.astype(np.float32)), t((b - m * s).astype(np.float32)))


def test_plain_matches_pallas_and_reference():
    import jax.numpy as jnp
    from checkerpose_tpu.ops.pallas_edgeconv import FusedEdgeConvParams, edgeconv_reference
    knn, x, kernel, g, b, m, v = _inputs()
    j = lambda a: jnp.asarray(a)  # noqa: E731
    ref = np.asarray(edgeconv_reference(j(x), knn, j(kernel), j(g), j(b), j(m), j(v)))
    pallas = np.asarray(FusedEdgeConvParams(knn, kernel, g, b, m, v, tile_n=64,
                                            dtype=jnp.float32)(j(x), interpret=True))
    w1, w2m1, s, bias = _folded(kernel, g, b, m, v)
    out = edgeconv_fused_plain(torch.from_numpy(x), torch.from_numpy(knn), w1, w2m1, s, bias)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), pallas, rtol=TOL, atol=TOL)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    knn, x, kernel, g, b, m, v = _inputs(1)
    w1, w2m1, s, bias = _folded(kernel, g, b, m, v)
    before = edgeconv_fused.launches
    args = (torch.from_numpy(x), torch.from_numpy(knn), w1, w2m1, s, bias)
    out = edgeconv_fused(*args)
    assert edgeconv_fused.launches == before
    assert torch.equal(out, edgeconv_fused_plain(*args))


def test_module_matches_flax_edgeconv():
    import jax
    import jax.numpy as jnp
    from checkerpose_tpu.models.graph import EdgeConv as FlaxEdgeConv
    knn, x, *_ = _inputs(2)
    fmod = FlaxEdgeConv(CP, 0.2, dtype=jnp.float32)
    variables = random_variables(fmod, jnp.asarray(x), knn, False)
    ref = np.asarray(jax.jit(lambda v, x: fmod.apply(v, x, knn, False))(variables, jnp.asarray(x)))
    mod = load_port(EdgeConv(C, CP, 0.2, dtype=torch.float32), variables)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), torch.from_numpy(knn))
    # same f32 math, BN folded into scale/bias: 1e-4
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_module_refuses_train_and_per_sample_graph():
    """Train mode runs (the per-node form with batch statistics). A
    per-sample (B, N, K) graph runs in either mode (the multi-object
    variant's plain path), equal to the static graph when every row is it,
    and folds nothing; a per-sample graph of another batch size or a graph
    of another rank is refused in either mode."""
    knn, x, *_ = _inputs(3)
    mod = EdgeConv(C, CP, dtype=torch.float32).train()
    xt, kt = torch.from_numpy(x), torch.from_numpy(knn)
    out = mod(xt, kt)
    assert out.shape == (B, N, CP) and out.requires_grad and mod.folds == 0
    per_sample = kt[None].expand(B, N, K).contiguous()
    for m in (mod, mod.eval()):
        with torch.no_grad():
            got = m(xt, per_sample)
            want = m(xt, kt)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError):
            m(xt, per_sample[:1])
        with pytest.raises(ValueError):
            m(xt, per_sample[None])
    assert mod.folds == 1                         # the static eval forward only


def _bad_calls():
    knn, x, kernel, g, b, m, v = _inputs(4)
    w1, w2m1, s, bias = _folded(kernel, g, b, m, v)
    xt, kt = torch.from_numpy(x), torch.from_numpy(knn)
    return {
        "x_float16": ((xt.half(), kt, w1.half(), w2m1.half(), s, bias), TypeError),
        "w_dtype_differs": ((xt, kt, w1.bfloat16(), w2m1, s, bias), TypeError),
        "knn_int64": ((xt, kt.long(), w1, w2m1, s, bias), ValueError),
        "knn_3d": ((xt, kt[None].expand(B, N, K).contiguous(), w1, w2m1, s, bias), ValueError),
        "knn_rows": ((xt, kt[:-1], w1, w2m1, s, bias), ValueError),
        "w_shape": ((xt, kt, w1[:-1], w2m1[:-1], s, bias), ValueError),
        "scale_f64": ((xt, kt, w1, w2m1, s.double(), bias), ValueError),
        "x_2d": ((xt[0], kt, w1, w2m1, s, bias), ValueError),
        "x_noncontiguous": ((xt.transpose(0, 1), kt[:B], w1, w2m1, s, bias), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects_bad_inputs(case):
    args, err = _bad_calls()[case]
    with pytest.raises(err):
        edgeconv_fused(*args)


def test_wrapper_rejects_negative_slope():
    knn, x, kernel, g, b, m, v = _inputs(5)
    with pytest.raises(ValueError):
        edgeconv_fused(torch.from_numpy(x), torch.from_numpy(knn),
                       *_folded(kernel, g, b, m, v), slope=-0.1)


BF16, F32 = torch.bfloat16, torch.float32
ROUTE_CASES = {
    # name: (dtype, N, K, C, C') -> route, or the error it raises
    "main_path_c64_bf16": ((BF16, 512, 20, 64, 64), "tc"),
    "main_path_c256_bf16": ((BF16, 512, 20, 256, 256), "tc"),
    "main_path_c64_f32": ((F32, 512, 20, 64, 64), "fma"),
    "main_path_c256_f32": ((F32, 512, 20, 256, 256), "fma"),
    "ragged_bf16": ((BF16, 100, 7, 48, 40), "tc"),
    "ragged_f32": ((F32, 100, 7, 48, 40), "fma"),
    "odd_channels_out_bf16": ((BF16, 128, 10, 64, 37), "tc"),
    "rows_off_16_bytes_bf16": ((BF16, 128, 10, 50, 64), "fma"),
    "n65_bf16": ((BF16, 65, 10, 64, 64), "tc"),
    "n600_narrow_bf16": ((BF16, 600, 20, 64, 64), "tc"),
    "n600_wide_bf16_over_tc_budget": ((BF16, 600, 20, 256, 256), "fma"),
    "n900_bf16_over_tc_budget": ((BF16, 900, 20, 256, 256), "fma"),
    "n2048_bf16_over_both": ((BF16, 2048, 20, 64, 64), ValueError),
    "n2048_f32_over_fma": ((F32, 2048, 20, 64, 64), ValueError),
    "float16": ((torch.float16, 128, 10, 64, 64), TypeError),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_rule(case):
    args, want = ROUTE_CASES[case]
    if isinstance(want, str):
        assert edgeconv_route(*args) == want
    else:
        with pytest.raises(want):
            edgeconv_route(*args)


def test_shared_memory_figures_of_the_main_path():
    """N=512, K=20: the FMA kernel's 140.5 KB; the tensor-core kernel's
    budget at C=256 (1 KB slack + W 32 KB + y 128 KB + z tile 18 KB +
    barriers leave 5 ring stages of 8 KB) and at C=64 (the ring is capped at
    8 stages)."""
    fixed = 1024 + 131072 + 18432 + 256
    assert fma_smem_bytes(512, 20) == 143872
    assert (tc_stages(512, 256), tc_smem_bytes(512, 256)) == (5, fixed + (4 + 5) * 8192)
    assert (tc_stages(512, 64), tc_smem_bytes(512, 64)) == (8, fixed + (1 + 8) * 8192)
    assert tc_smem_bytes(512, 256) <= MAX_SMEM and tc_smem_bytes(600, 256) == 0


@pytest.mark.parametrize("C,Cp", [(64, 64), (48, 40), (256, 128)],
                         ids=["tiled", "ragged", "wide"])
def test_packed_weights_unpack_exactly(C, Cp):
    rng = np.random.default_rng(7)
    w1 = torch.from_numpy(rng.standard_normal((C, Cp)).astype(np.float32)).bfloat16()
    w2m1 = torch.from_numpy(rng.standard_normal((C, Cp)).astype(np.float32)).bfloat16()
    packed = pack_edgeconv_weights(w1, w2m1)
    ct, kt = -(-Cp // 64), -(-C // 64)
    assert packed.shape == (2, ct, kt, 64, 64) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    # tile (chunk, ks) holds W[ks*64 + k, chunk*64 + c] at [c, k]: K-major
    assert packed[1, ct - 1, kt - 1, 3, 5] == w2m1[(kt - 1) * 64 + 5, (ct - 1) * 64 + 3]
    # the zero padding carries no weight
    assert int((packed != 0).sum()) == int((w1 != 0).sum() + (w2m1 != 0).sum())
    u1, u2 = unpack_edgeconv_weights(packed, C, Cp)
    assert torch.equal(u1, w1) and torch.equal(u2, w2m1)


def test_plain_on_unpacked_weights_matches_pallas_and_reference():
    import jax.numpy as jnp
    from checkerpose_tpu.ops.pallas_edgeconv import FusedEdgeConvParams, edgeconv_reference
    knn, x, kernel, g, b, m, v = _inputs(8)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    ref = np.asarray(edgeconv_reference(j(x), knn, j(kernel), j(g), j(b), j(m), j(v)))
    pallas = np.asarray(FusedEdgeConvParams(knn, kernel, g, b, m, v, tile_n=64,
                                            dtype=jnp.float32)(j(x), interpret=True))
    w1, w2m1, s, bias = _folded(kernel, g, b, m, v)
    u1, u2 = unpack_edgeconv_weights(pack_edgeconv_weights(w1, w2m1), C, CP)
    xt, kt = torch.from_numpy(x), torch.from_numpy(knn)
    out = edgeconv_fused_plain(xt, kt, u1, u2, s, bias)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), pallas, rtol=TOL, atol=TOL)
    # the wrapper takes the packed weights beside the plain ones
    assert torch.equal(edgeconv_fused(xt, kt, w1, w2m1, s, bias,
                                      packed=pack_edgeconv_weights(w1, w2m1)), out)


def test_wrapper_rejects_bad_packed():
    knn, x, kernel, g, b, m, v = _inputs(9)
    w1, w2m1, s, bias = _folded(kernel, g, b, m, v)
    args = (torch.from_numpy(x), torch.from_numpy(knn), w1, w2m1, s, bias)
    packed = pack_edgeconv_weights(w1, w2m1)
    with pytest.raises(ValueError, match="packed"):
        edgeconv_fused(*args, packed=packed[:, :, :, :32])
    with pytest.raises(ValueError, match="packed"):
        edgeconv_fused(*args, packed=packed.bfloat16())


def test_module_folds_once_and_follows_new_weights():
    """Two eval forwards fold and pack once; after load_state_dict with other
    weights the output follows them (and still matches Flax at 1e-4); train()
    and .to() drop the kept weights; CPU calls count no launch on any route."""
    import jax
    import jax.numpy as jnp
    from checkerpose_tpu.models.graph import EdgeConv as FlaxEdgeConv
    knn, x, *_ = _inputs(10)
    fmod = FlaxEdgeConv(CP, 0.2, dtype=jnp.float32)
    apply = jax.jit(lambda v, x: fmod.apply(v, x, knn, False))
    vars_a = random_variables(fmod, jnp.asarray(x), knn, False, seed=1)
    vars_b = random_variables(fmod, jnp.asarray(x), knn, False, seed=2)
    xt, kt = torch.from_numpy(x), torch.from_numpy(knn)
    before = (edgeconv_fused.launches, dict(edgeconv_fused.launches_by_route))

    mod = load_port(EdgeConv(C, CP, 0.2, dtype=torch.float32), vars_a)
    with torch.no_grad():
        out_a, out_a2 = mod(xt, kt), mod(xt, kt)
    assert mod.folds == 1 and torch.equal(out_a, out_a2)
    np.testing.assert_allclose(out_a.numpy(), np.asarray(apply(vars_a, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)

    load_port(mod, vars_b)
    with torch.no_grad():
        out_b = mod(xt, kt)
    assert mod.folds == 2 and not torch.allclose(out_a, out_b, atol=1e-2)
    np.testing.assert_allclose(out_b.numpy(), np.asarray(apply(vars_b, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)

    with torch.no_grad():
        mod.bn.running_mean.add_(1.0)            # a statistic written in place
        out_c = mod(xt, kt)
    assert mod.folds == 3 and not torch.allclose(out_b, out_c, atol=1e-2)
    mod.train().eval()
    with torch.no_grad():
        mod(xt, kt)
    assert mod.folds == 4
    mod.to(torch.float64).to(torch.float32)
    with torch.no_grad():
        assert torch.equal(mod(xt, kt), out_c) and mod(xt, kt) is not None
    assert mod.folds == 5
    assert (edgeconv_fused.launches, edgeconv_fused.launches_by_route) == before


def _reload_assign(mod, other):
    mod.load_state_dict(other.state_dict(), assign=True)


def _replace_parameter(mod, other):
    mod.conv.weight = torch.nn.Parameter(other.conv.weight.detach().clone())
    mod.bn.running_mean = other.bn.running_mean.clone()


def _write_under_inference_mode(mod, other):
    with torch.inference_mode():
        mod.load_state_dict(other.state_dict())


@pytest.mark.parametrize("swap", [_reload_assign, _replace_parameter,
                                  _write_under_inference_mode],
                         ids=["assign", "new-parameter", "inference-mode-write"])
def test_module_refolds_when_weights_are_replaced(swap):
    """Weights that arrive as new tensors (no version counter moves on the
    old ones) are folded again, and the output equals a fresh module's."""
    knn, x, *_ = _inputs(12)
    xt, kt = torch.from_numpy(x), torch.from_numpy(knn)
    torch.manual_seed(3)
    mod = EdgeConv(C, CP, dtype=torch.float32).eval()
    other = EdgeConv(C, CP, dtype=torch.float32).eval()
    with torch.no_grad():
        other.conv.weight.mul_(-1.5)
        other.bn.running_mean.add_(0.7)
        out_old, want = mod(xt, kt), other(xt, kt)
    assert mod.folds == 1 and not torch.allclose(out_old, want, atol=1e-2)
    swap(mod, other)
    with torch.no_grad():
        got = mod(xt, kt)
        mod(xt, kt)
    assert mod.folds == 2 and torch.equal(got, want)


def test_module_of_inference_tensors_folds_every_forward():
    """Inference tensors have no version counter to watch, so nothing is
    kept for a module built under torch.inference_mode()."""
    knn, x, *_ = _inputs(13)
    xt, kt = torch.from_numpy(x), torch.from_numpy(knn)
    with torch.inference_mode():
        mod = EdgeConv(C, CP, dtype=torch.float32).eval()
        out = mod(xt, kt)
        mod.bn.running_mean.add_(1.0)
        moved = mod(xt, kt)
    assert mod.folds == 2 and not torch.allclose(out, moved, atol=1e-2)


def test_module_packs_bf16_weights_for_the_tensor_core_route():
    mod = EdgeConv(C, CP, dtype=torch.bfloat16).eval()
    w1, w2m1, scale, bias, packed = mod.fused_args()
    assert packed.dtype == torch.bfloat16 and packed.shape == (2, 1, 1, 64, 64)
    u1, u2 = unpack_edgeconv_weights(packed, C, CP)
    assert torch.equal(u1, w1) and torch.equal(u2, w2m1)
    assert mod.fused_args()[4] is packed and mod.folds == 1
    assert EdgeConv(C, CP, dtype=torch.float32).eval().fused_args()[4] is None
    knn, x, *_ = _inputs(11)
    mod.train()                                   # train mode keeps nothing
    mod.fused_args(), mod.fused_args()
    assert mod.folds == 3


CARD_CASES = [("tc", torch.bfloat16), ("fma", torch.float32), ("fma", torch.bfloat16)]
CARD_IDS = ["tc-bf16", "fma-f32", "fma-bf16"]


def _card_inputs(shape, dtype, seed=6, scale_sign=None):
    b_, n_, c_, cp_, k_ = shape
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    knn = torch.from_numpy(knn_index(rng.standard_normal((n_, 3)), k_)).to(dev)
    x = torch.from_numpy(rng.standard_normal((b_, n_, c_)).astype(np.float32)).to(dev, dtype)
    kernel = (rng.standard_normal((2 * c_, cp_)) * 0.1).astype(np.float32)
    g = rng.standard_normal(cp_).astype(np.float32)
    if scale_sign is not None:
        g = scale_sign * (np.abs(g) + 0.1)
    v = (np.abs(rng.standard_normal(cp_)) + 0.5).astype(np.float32)
    w1, w2m1, s, bias = (t.to(dev) for t in _folded(kernel, g, 0.1 * g, 0.1 * g, v, dtype))
    return x, knn, w1, w2m1, s, bias


def _hold_on_card(route, args):
    """Launch `route` once and hold it against the plain version: f32 at
    2e-3; bf16 against the plain version in f32 on the same bf16-rounded
    inputs at 1e-3 + 2^-8 |ref| (bf16 output rounding)."""
    x, knn, w1, w2m1, s, bias = args
    before = dict(edgeconv_fused.launches_by_route)
    total = edgeconv_fused.launches
    out = _launch(route, *args)
    torch.cuda.synchronize()
    other = "fma" if route == "tc" else "tc"
    assert edgeconv_fused.launches == total + 1
    assert edgeconv_fused.launches_by_route[route] == before[route] + 1
    assert edgeconv_fused.launches_by_route[other] == before[other]
    _assert_close_to_plain(out, args)


def _assert_close_to_plain(out, args):
    x, knn, w1, w2m1, s, bias = args
    ref = edgeconv_fused_plain(x.float(), knn, w1.float(), w2m1.float(), s, bias)
    if x.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    else:
        err = (out.float() - ref).abs()
        assert bool((err <= 1e-3 + 2 ** -8 * ref.abs()).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
@pytest.mark.parametrize("shape", [(2, 128, 64, 64, 10), (3, 100, 48, 40, 7)],
                         ids=["tiled", "ragged"])
def test_kernel_matches_plain_on_card(case, shape):
    """Both CUDA kernels vs the plain version on the card. "ragged" leaves
    partial node, channel and input-channel tiles."""
    require_cuda()
    route, dtype = case
    _hold_on_card(route, _card_inputs(shape, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 128, 64, 64, 10), (3, 100, 48, 40, 7)],
                         ids=["tiled", "ragged"])
def test_unforced_route_follows_the_rule_on_card(shape):
    require_cuda()
    b_, n_, c_, cp_, k_ = shape
    for dtype in (torch.bfloat16, torch.float32):
        args = _card_inputs(shape, dtype)
        want = edgeconv_route(dtype, n_, k_, c_, cp_)
        before = edgeconv_fused.launches_by_route[want]
        packed = pack_edgeconv_weights(args[2], args[3])
        a = edgeconv_fused(*args)
        b = edgeconv_fused(*args, packed=packed)
        torch.cuda.synchronize()
        assert edgeconv_fused.launches_by_route[want] == before + 2
        assert torch.equal(a, b)                  # packing on the fly or ahead: same bits
        _assert_close_to_plain(a, args)


def _cancellation_case(dtype, device):
    """W2 = 0, so z = -y[n] and out = leaky(s * (y[j] - y[n]) + b); every node
    is one large vector plus small noise, so |y| is ~100x |y[j] - y[n]|."""
    b_, n_, c_, cp_, k_ = 2, 128, 64, 64, 10
    rng = np.random.default_rng(12)
    knn = torch.from_numpy(knn_index(rng.standard_normal((n_, 3)), k_)).to(device)
    big = 30.0 * rng.standard_normal((b_, 1, c_))
    x = torch.from_numpy((big + 0.3 * rng.standard_normal((b_, n_, c_))).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((c_, cp_)) * 0.1).astype(np.float32))
    x, w1 = x.to(device, dtype), w1.to(device, dtype)
    s = torch.from_numpy(rng.uniform(0.5, 1.5, cp_).astype(np.float32)).to(device)
    s[::3] *= -1.0
    return x, knn, w1, (-w1).contiguous(), s, torch.zeros(cp_, device=device)


def test_cancellation_case_tells_a_bf16_y_from_an_f32_y():
    """The card test below rests on this: with y rounded to bf16 before the
    add, the same arithmetic is off by ~2^-9 |y| and breaks the bf16 bar
    1e-3 + 2^-8 |ref| on many outputs; with y in f32 it holds everywhere."""
    x, knn, w1, w2m1, s, bias = _cancellation_case(torch.bfloat16, torch.device("cpu"))
    ref = edgeconv_fused_plain(x.float(), knn, w1.float(), w2m1.float(), s, bias)
    y = x.float() @ w1.float()
    spread = (y[:, knn.long()] - y[:, :, None]).abs().mean()
    assert float(y.abs().mean()) > 50 * float(spread)        # the case is what it says
    bar = 1e-3 + 2 ** -8 * ref.abs()

    def fused(y_used):
        e = (y_used[:, knn.long()] - y[:, :, None]) * s + bias
        return torch.where(e >= 0, e, e * 0.2).amax(dim=2)

    assert bool(((fused(y) - ref).abs() <= bar).all())
    rounded = fused(y.bfloat16().float())
    assert float(((rounded - ref).abs() > bar).float().mean()) > 0.2
    out = edgeconv_fused(x, knn, w1, w2m1, s, bias)          # the wrapper's CPU path
    assert bool(((out.float() - ref).abs() <= bar).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
def test_kernel_keeps_y_in_f32_under_cancellation(case):
    """A kernel that rounds y (or z) to bf16 anywhere before the add is off
    by ~2^-9 |y| ~ 0.05 on the cancellation case and fails the bar
    1e-3 + 2^-8 |ref| (|ref| ~ 0.3)."""
    require_cuda()
    route, dtype = case
    _hold_on_card(route, _cancellation_case(dtype, torch.device("cuda")))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
def test_kernel_all_negative_scale_takes_the_min_branch(case):
    require_cuda()
    route, dtype = case
    _hold_on_card(route, _card_inputs((2, 128, 64, 64, 10), dtype, scale_sign=-1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
def test_kernel_takes_duplicate_neighbours(case):
    require_cuda()
    route, dtype = case
    x, knn, *rest = _card_inputs((2, 128, 64, 64, 10), dtype)
    knn = knn.clone()
    knn[:, 5:] = knn[:, :5]                       # every row lists its neighbours twice
    knn[7] = 7                                    # and one node only itself
    _hold_on_card(route, (x, knn.contiguous(), *rest))


@pytest.mark.gpu
@pytest.mark.parametrize("n_", [65, 600])
def test_kernel_node_counts_off_the_tile(n_):
    """N = 65 leaves one node in the last 64-node tile; N = 600 is past the
    main path's 512 and still inside both kernels' shared memory at C = 64."""
    require_cuda()
    assert edgeconv_route(torch.bfloat16, n_, 20, 64, 64) == "tc"
    for route, dtype in CARD_CASES:
        _hold_on_card(route, _card_inputs((2, n_, 64, 64, 20), dtype))


@pytest.mark.gpu
def test_python_shared_memory_figures_equal_the_c_functions():
    require_cuda()
    from checkerpose_tpu_torch.ops.edgeconv import _lib
    fma, tc = _lib("fma"), _lib("tc")
    assert fma.edgeconv_fused_max_smem_bytes() == MAX_SMEM
    for n_, k_ in [(512, 20), (100, 7), (65, 10), (600, 20), (1100, 20), (2048, 20)]:
        assert fma.edgeconv_fused_smem_bytes(n_, k_) == fma_smem_bytes(n_, k_)
    for n_, c_ in [(512, 64), (512, 256), (100, 48), (65, 64), (600, 64), (600, 256),
                   (900, 256), (2048, 64)]:
        assert tc.edgeconv_tc_stages(n_, c_) == tc_stages(n_, c_)
        assert tc.edgeconv_tc_smem_bytes(n_, c_) == tc_smem_bytes(n_, c_)


@pytest.mark.gpu
def test_tensor_core_kernel_refuses_what_it_does_not_take():
    require_cuda()
    args = _card_inputs((2, 128, 64, 64, 10), torch.float32)
    before = edgeconv_fused.launches
    with pytest.raises(ValueError, match="tensor-core"):
        _launch("tc", *args)
    assert edgeconv_fused.launches == before


@pytest.mark.gpu
def test_kernel_refuses_graph_beyond_shared_memory():
    """N=2048, K=20 needs more than the 227 KB a block can use: the wrapper
    raises before launching."""
    require_cuda()
    dev = torch.device("cuda")
    n_, k_ = 2048, 20
    x = torch.zeros(1, n_, 8, device=dev)
    knn = torch.zeros(n_, k_, dtype=torch.int32, device=dev)
    w = torch.zeros(8, 8, device=dev)
    sb = torch.zeros(8, device=dev)
    before = edgeconv_fused.launches
    with pytest.raises(ValueError, match="shared memory"):
        edgeconv_fused(x, knn, w, w, sb, sb)
    assert edgeconv_fused.launches == before
