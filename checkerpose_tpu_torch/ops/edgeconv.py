"""Fused inference EdgeConv (BN folded): CUDA kernel wrappers + plain version,
and the training form in plain PyTorch (`edgeconv_train`).

Port of checkerpose_tpu/ops/pallas_edgeconv.py::edgeconv_fused_pallas:

    out[b, n] = max_k leaky(scale * ([x_j - x_i ; x_i] @ W) + bias)
              = max_k leaky(scale * ((x @ W1)[knn[n, k]] + (x @ (W2 - W1))[n]) + bias)

over a static (N, K) KNN graph. Two hand-written kernels compute it on the
card, and `edgeconv_route` picks one from the dtype and the shapes alone:

  "tc"   `csrc/edgeconv_tc.cu`: bf16, both projections on the tensor cores
         (wgmma), x tiles by asynchronous copies (TMA); needs C % 8 == 0 and
         a graph whose y = x @ W1 chunk fits in shared memory beside its tiles;
  "fma"  `csrc/edgeconv.cu`: exact f32 FMA on the CUDA cores (no TF32),
         register-tiled (8 nodes x 8 channels a thread), x and W tiles by
         TMA into a 2-stage mbarrier ring (element copies for bf16, C % 4
         != 0 and x off a 16-byte line), a 64-channel y chunk up to N = 583
         (`fma_config`); for f32 inputs and for bf16 shapes the tensor-core
         kernel does not take.

`edgeconv_fused` launches one of them for CUDA tensors and runs
`edgeconv_fused_plain` for CPU tensors only; for a CUDA tensor it launches a
kernel or raises, with no fallback. `edgeconv_fused.launches` counts kernel
launches (never the plain version's calls) and
`edgeconv_fused.launches_by_route` splits that count by route.

A per-sample (B, N, K) graph (the multi-object variant: each sample reads its
own object's graph) never reaches a kernel, as it never reaches the Pallas
kernel in the JAX package (`checkerpose_tpu/models/graph.py::EdgeConv` sends
a 3-D index to XLA): `edgeconv_train` trains on either graph, and
`edgeconv_eval_per_sample` evaluates on a per-sample one with BatchNorm's
running statistics unfolded, in plain PyTorch on every device.
`edgeconv_eval_per_sample.calls` counts its calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from checkerpose_tpu_torch.ops import _build
from checkerpose_tpu_torch.utils import counters
from checkerpose_tpu_torch.utils.counters import reset_launch_counts  # noqa: F401

_DTYPES = (torch.float32, torch.bfloat16)

# Shared-memory constants, mirrored from the two .cu sources (a card test
# holds these figures against the C functions).
MAX_SMEM = 232448                   # bytes of shared memory a block may use
_FMA_TN, _FMA_STAGES = 256, 2                # nodes of a tile, stages of the ring
_FMA_CONFIGS = ((64, 32), (32, 32), (32, 16))  # (output, input channels a stage), in order
_FMA_ALIGN, _FMA_BAR_BYTES = 1024, 64         # ring alignment slack, its mbarriers
TC_TILE = 64                        # rows, k-columns and channels of a tile
_TC_TILE_BYTES = TC_TILE * TC_TILE * 2
_TC_ALIGN = 1024                    # swizzled tiles start on 1024-byte lines
_TC_ZS_STRIDE = TC_TILE + 8         # padded f32 row of the z staging tile
_TC_BAR_BYTES = 256                 # the ring's and the W chunk's mbarriers
TC_MIN_STAGES, TC_MAX_STAGES = 3, 8


def edgeconv_fused_plain(x, knn, w1, w2m1, scale, bias, slope: float = 0.2):
    """Same function in plain PyTorch, computed in f32: per-node matmuls,
    gather, add, scale/bias, leaky, max over K. Returns x's dtype."""
    xf = x.float()
    y = xf @ w1.float()                                  # (B, N, C')
    z = xf @ w2m1.float()
    e = y[:, knn.long()] + z[:, :, None, :]              # (B, N, K, C')
    e = e * scale.float() + bias.float()
    e = torch.where(e >= 0, e, e * slope)
    return e.amax(dim=2).to(x.dtype)


def gather_neighbors(y, knn):
    """Neighbour rows of y (B, N, C): a static (N, K) graph gives y[:, knn],
    a per-sample (B, N, K) one `torch.gather` over dim 1 with the (B, N*K)
    index expanded over the channels (the JAX package's `take_along_axis`
    form). Returns (B, N, K, C) of y's dtype. Autograd's backward of either
    is a scatter-add of the K contributions per node in y's dtype (bf16 in a
    bf16 net, as the JAX package's transpose of the gather); on the card it
    adds with atomics, so its rounding order is not deterministic."""
    knn = knn.long()
    if knn.dim() == 2:
        return y[:, knn]
    if knn.dim() != 3 or knn.shape[0] != y.shape[0] or knn.shape[1] != y.shape[1]:
        raise ValueError(f"knn must be (N, K) or (B, N, K) for y {tuple(y.shape)}, "
                         f"got {tuple(knn.shape)}")
    B, N, K = knn.shape
    idx = knn.reshape(B, N * K, 1).expand(B, N * K, y.shape[-1])
    return torch.gather(y, 1, idx).view(B, N, K, y.shape[-1])


def edgeconv_train(x, knn, w1, w2m1, bn, slope: float = 0.2):
    """Training EdgeConv, the per-node form the JAX package trains with
    (checkerpose_tpu/models/graph.py::EdgeConv, `train=True`):

        y = x @ w1, z = x @ w2m1, e = gather_neighbors(y, knn) + z[:, :, None, :]
        out = max_k leaky(bn(e))

    on a static (N, K) or a per-sample (B, N, K) graph. `bn` is called on
    the whole (B, N, K, C') edge tensor with the channel last and returns
    f32 (a models/layers.py::BatchNorm in train mode takes the batch
    statistics over (B, N, K) and updates its running ones); the result is
    cast to x's dtype before the activation. Plain PyTorch on any device:
    the JAX package runs no kernel here either, and autograd gives the
    backward (see `gather_neighbors` for the gather's)."""
    y = x @ w1                                           # (B, N, C')
    z = x @ w2m1
    e = gather_neighbors(y, knn) + z[:, :, None, :]      # (B, N, K, C')
    e = F.leaky_relu(bn(e, channel_dim=-1).to(x.dtype), slope)
    return e.amax(dim=2)


def edgeconv_eval_per_sample(x, knn, w1, w2m1, bn, slope: float = 0.2):
    """Inference EdgeConv on a per-sample (B, N, K) graph, the arithmetic of
    the JAX package's XLA path for that index: y = x @ w1 and z = x @ w2m1
    in x's dtype, e = gather(y) + z in that dtype, BatchNorm with the
    running statistics in f32, unfolded (`bn` in eval mode), cast back,
    leaky, max over K. Not a fallback from the kernels, which take a static
    graph only: the one path for this index on every device. Counts its
    calls in `edgeconv_eval_per_sample.calls`."""
    if knn.dim() != 3:
        raise ValueError(f"knn must be a per-sample (B, N, K) graph, got {tuple(knn.shape)}")
    if bn.training:
        raise RuntimeError("edgeconv_eval_per_sample reads the running statistics: "
                           "bn must be in eval mode")
    edgeconv_eval_per_sample.calls += 1
    # the training arithmetic; `bn` in eval mode reads its running statistics
    return edgeconv_train(x, knn, w1, w2m1, bn, slope)


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def _fma_bytes(N: int, chunk: int, tk: int) -> int:
    """The FMA kernel's ring (x and W boxes of `tk` input channels, f32), its
    y chunk for all N nodes (f32) and the ring's mbarriers at `chunk` output
    channels a block."""
    return (_FMA_ALIGN + 4 * (_FMA_STAGES * tk * (_FMA_TN + chunk) + N * chunk)
            + _FMA_BAR_BYTES)


def fma_config(N: int):
    """(output channels a block, input channels a ring stage) of the FMA
    kernel at N: the first of (64, 32), (32, 32), (32, 16) that fits, N <=
    583, 1231, 1519; past that the last, which does not fit. A launch
    whose 64-channel chunks would give fewer blocks than the card has SMs
    (B * ceil(C'/64) < 132 on an H100) takes (32, 32) in their place, in
    less shared memory than this figure."""
    for chunk, tk in _FMA_CONFIGS:
        if _fma_bytes(N, chunk, tk) <= MAX_SMEM:
            return chunk, tk
    return _FMA_CONFIGS[-1]


def fma_smem_bytes(N: int, K: int) -> int:
    """Dynamic shared memory of one block of the FMA kernel at N's config.
    K does not enter: the kernel reads knn from device memory."""
    del K
    return _fma_bytes(N, *fma_config(N))


def _tc_fixed_bytes(N: int, C: int) -> int:
    """Alignment slack, the W chunk of one projection, the f32 y chunk for
    all N nodes, the z staging tile and the mbarriers."""
    return (_TC_ALIGN + _ceil_to(C, TC_TILE) // TC_TILE * _TC_TILE_BYTES
            + _ceil_to(N, TC_TILE) * TC_TILE * 4 + TC_TILE * _TC_ZS_STRIDE * 4
            + _TC_BAR_BYTES)


def tc_stages(N: int, C: int) -> int:
    """Stages of the tensor-core kernel's ring of x tiles: what is left of
    a block's shared memory after the fixed part, in 8 KB tiles, at most
    TC_MAX_STAGES.
    Below TC_MIN_STAGES the kernel does not take the shape."""
    return max(0, min(TC_MAX_STAGES, (MAX_SMEM - _tc_fixed_bytes(N, C)) // _TC_TILE_BYTES))


def tc_smem_bytes(N: int, C: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel, ring
    included; 0 where the shape does not fit."""
    stages = tc_stages(N, C)
    if stages < TC_MIN_STAGES:
        return 0
    return _tc_fixed_bytes(N, C) + stages * _TC_TILE_BYTES


def _tc_takes(dtype, N: int, C: int) -> bool:
    """bf16, x rows on 16-byte lines, and a ring of at least 3 stages."""
    return dtype == torch.bfloat16 and C % 8 == 0 and tc_stages(N, C) >= TC_MIN_STAGES


def edgeconv_route(dtype, N: int, K: int, C: int, Cp: int) -> str:
    """Which kernel takes x (B, N, C) of `dtype` on a (N, K) graph with C'
    = Cp output channels: "tc" or "fma". Raises ValueError where neither
    does. Pure Python: no card needed."""
    if dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    if _tc_takes(dtype, N, C):
        return "tc"
    smem = fma_smem_bytes(N, K)
    if smem <= MAX_SMEM:
        return "fma"
    raise ValueError(f"N={N}, K={K}, C={C} {dtype}: the FMA kernel needs {smem} B of shared "
                     f"memory, above the {MAX_SMEM} B a block can use, and the "
                     f"tensor-core kernel does not take the shape either")


def pack_edgeconv_weights(w1, w2m1):
    """[W1 | W2-W1] in the layout the tensor-core kernel reads: K-major
    (transposed) 64x64 tiles, zero-padded, shape (2, ceil(C'/64),
    ceil(C/64), 64 channels, 64 k), so the tiles of one 64-channel chunk of
    one projection are contiguous. Keeps the dtype."""
    C, Cp = w1.shape
    w = torch.stack([w1, w2m1])                                      # (2, C, C')
    w = F.pad(w, (0, _ceil_to(Cp, TC_TILE) - Cp, 0, _ceil_to(C, TC_TILE) - C))
    w = w.view(2, w.shape[1] // TC_TILE, TC_TILE, w.shape[2] // TC_TILE, TC_TILE)
    return w.permute(0, 3, 1, 4, 2).contiguous()                     # (2, chunk, ks, c', k)


def unpack_edgeconv_weights(packed, C: int, Cp: int):
    """(w1, w2m1) of shape (C, C') back out of `pack_edgeconv_weights`."""
    w = packed.permute(0, 2, 4, 1, 3).reshape(2, packed.shape[2] * TC_TILE,
                                              packed.shape[1] * TC_TILE)
    return w[0, :C, :Cp].contiguous(), w[1, :C, :Cp].contiguous()


def _check(x, knn, w1, w2m1, scale, bias, slope):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got {tuple(x.shape)}")
    if knn.dim() != 2:
        raise ValueError(f"knn must be a static (N, K) graph, got {tuple(knn.shape)} "
                         f"(a per-sample graph goes to edgeconv_eval_per_sample)")
    B, N, C = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if knn.dtype != torch.int32 or knn.shape[0] != N:
        raise ValueError(f"knn must be int32 ({N}, K), got {knn.dtype} {tuple(knn.shape)}")
    if w1.dim() != 2 or w1.shape[0] != C or w2m1.shape != w1.shape:
        raise ValueError(f"w1 and w2m1 must be ({C}, C'), got "
                         f"{tuple(w1.shape)} and {tuple(w2m1.shape)}")
    if w1.dtype != x.dtype or w2m1.dtype != x.dtype:
        raise TypeError(f"w1 and w2m1 must have x's dtype {x.dtype}, got "
                        f"{w1.dtype} and {w2m1.dtype}")
    Cp = w1.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (Cp,):
            raise ValueError(f"{name} must be float32 ({Cp},), got {t.dtype} {tuple(t.shape)}")
    if not slope >= 0:
        raise ValueError(f"slope must be >= 0, got {slope}")
    tensors = (x, knn, w1, w2m1, scale, bias)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")


def _check_packed(packed, x, C, Cp):
    shape = (2, _ceil_to(Cp, TC_TILE) // TC_TILE, _ceil_to(C, TC_TILE) // TC_TILE,
             TC_TILE, TC_TILE)
    if (tuple(packed.shape) != shape or packed.dtype != x.dtype
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"packed must be contiguous {x.dtype} {shape} on {x.device} "
                         f"(pack_edgeconv_weights), got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")


def _typed(lib: ctypes.CDLL, route: str) -> ctypes.CDLL:
    """Declare the C functions' argument and result types, once per library."""
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if route == "tc":
            lib.edgeconv_tc_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, p]
            lib.edgeconv_tc_launch.restype = i
            lib.edgeconv_tc_smem_bytes.argtypes = [i, i]
            lib.edgeconv_tc_smem_bytes.restype = ctypes.c_size_t
            lib.edgeconv_tc_stages.argtypes = [i, i]
            lib.edgeconv_tc_stages.restype = i
        else:
            lib.edgeconv_fused_launch.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
            lib.edgeconv_fused_launch.restype = i
            lib.edgeconv_fused_smem_bytes.argtypes = [i, i]
            lib.edgeconv_fused_smem_bytes.restype = ctypes.c_size_t
            lib.edgeconv_fused_max_smem_bytes.argtypes = []
            lib.edgeconv_fused_max_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _lib(route: str) -> ctypes.CDLL:
    """The typed library of a route, built at first use."""
    return _typed(_build.load("edgeconv_tc" if route == "tc" else "edgeconv"), route)


def _launch(route: str, x, knn, w1, w2m1, scale, bias, slope: float = 0.2, packed=None):
    """Launch the kernel of `route` on checked CUDA inputs and count it;
    raises where that kernel does not take the call. `edgeconv_fused` picks
    the route; chip_smoke.py and the card tests call this to hold each kernel
    against the plain version on the same inputs."""
    B, N, C = x.shape
    K, Cp = knn.shape[1], w1.shape[1]
    if route == "tc":
        if not _tc_takes(x.dtype, N, C) or x.data_ptr() % 16:
            raise ValueError(f"the tensor-core kernel takes bf16 on a 16-byte line with "
                             f"C % 8 == 0 and a graph that fits its shared memory, got "
                             f"{x.dtype} N={N} C={C}")
        if packed is None:
            packed = pack_edgeconv_weights(w1, w2m1)
    else:
        smem = fma_smem_bytes(N, K)
        if smem > MAX_SMEM:
            raise ValueError(f"N={N}, K={K} needs {smem} B of shared memory, "
                             f"above the {MAX_SMEM} B a block can use")
        if B > 65535:
            raise ValueError(f"batch {B} exceeds the kernel's grid limit 65535")

    lib = _lib(route)
    out = torch.empty((B, N, Cp), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "tc":
            err = lib.edgeconv_tc_launch(
                x.data_ptr(), knn.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), B, N, C, Cp, K, float(slope), stream)
        else:
            err = lib.edgeconv_fused_launch(
                int(x.dtype == torch.bfloat16), x.data_ptr(), knn.data_ptr(),
                w1.data_ptr(), w2m1.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, N, C, Cp, K, float(slope), stream)
    if err != 0:
        raise RuntimeError(f"edgeconv_fused ({route}) kernel launch failed: CUDA error {err}")
    edgeconv_fused.launches += 1
    edgeconv_fused.launches_by_route[route] += 1
    return out


def edgeconv_fused(x, knn, w1, w2m1, scale, bias, slope: float = 0.2,
                   packed: Optional[torch.Tensor] = None):
    """x (B, N, C) f32/bf16; knn (N, K) int32 with entries in [0, N);
    w1, w2m1 (C, C') of x's dtype; scale, bias (C',) f32. Returns (B, N, C')
    of x's dtype.

    `packed` is `pack_edgeconv_weights(w1, w2m1)` where the caller keeps it
    (the tensor-core kernel reads it; without it the weights are packed on
    every call)."""
    _check(x, knn, w1, w2m1, scale, bias, slope)
    B, N, C = x.shape
    K, Cp = knn.shape[1], w1.shape[1]
    if packed is not None:
        _check_packed(packed, x, C, Cp)
    if x.device.type == "cpu":
        return edgeconv_fused_plain(x, knn, w1, w2m1, scale, bias, slope)
    if x.device.type != "cuda":
        raise ValueError(f"edgeconv_fused runs on cuda or cpu tensors, got {x.device}")
    route = edgeconv_route(x.dtype, N, K, C, Cp)
    if route == "tc" and x.data_ptr() % 16:          # a view off a 16-byte line
        route = "fma"
    return _launch(route, x, knn, w1, w2m1, scale, bias, slope, packed)


@counters.register
def _reset_counts():
    """Zero the kernels' launch counts and the per-sample path's call count
    (`reset_launch_counts()`, imported here, zeroes them with every other
    module's counts)."""
    edgeconv_fused.launches = 0
    edgeconv_fused.launches_by_route = {"tc": 0, "fma": 0}
    edgeconv_eval_per_sample.calls = 0
