"""Shared NN building blocks (NCHW, bf16 compute / f32 params and BN).

Counterpart of checkerpose_tpu/models/layers.py. Module and parameter names
follow the Flax tree so that models/convert.py maps leaves by path. Precision
is explicit, as Flax's `dtype=` is: each conv and dense layer casts its input
and its f32 parameters to `dtype`; BatchNorm computes in f32 (eps 1e-5) and
the caller casts back. `nn.Module.train()` / `eval()` decides BatchNorm's mode:
batch statistics with Flax's formula and running-stat update in train mode,
running statistics in eval mode.

Initialisation follows the Flax defaults: lecun-normal kernels (truncated
normal, fan-in scaling), zero biases, BN and LayerNorm scale 1 / bias 0, BN
mean 0 / var 1. `init_params(module, generator)` re-draws every kernel from a
torch.Generator.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# stddev correction of a unit normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """Flax `lecun_normal`: normal truncated at +-2 std, variance 1/fan_in,
    drawn by inverting the normal CDF on a uniform sample."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    u = lo + u * (1.0 - 2.0 * lo)
    x = torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)
    with torch.no_grad():
        t.copy_(x.to(t.dtype))


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise, in `modules()` order, every module that has a
    `reset_parameters(generator)`: the layers here and the blocks that hold
    a parameter of their own (ConvNeXt's layer scale). The port builds no
    torch layer with parameters."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def _same_pads(n: int, k: int, s: int):
    """(lo, hi) padding of XLA/Flax "SAME": stride 2 pads (0, 1) on an even
    input, unlike torch's symmetric padding=1."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """Flax `nn.Conv` on NCHW: weight (O, I / groups, kH, kW); padding
    "SAME" or an int applied on both sides; `groups` is Flax's
    `feature_group_count` (groups = cin: depthwise)."""

    def __init__(self, cin: int, cout: int, kernel=3, stride: int = 1,
                 padding="SAME", bias: bool = False, groups: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        O, I, kh, kw = self.weight.shape
        lecun_normal_(self.weight, I * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(self.dtype)
        kh, kw = self.weight.shape[2:]
        if self.padding == "SAME":
            ph = _same_pads(x.shape[2], kh, self.stride)
            pw = _same_pads(x.shape[3], kw, self.stride)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                pad = 0
        else:
            pad = self.padding
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, stride=self.stride,
                        padding=pad, groups=self.groups)


class ConvTranspose2d(nn.Module):
    """Flax `nn.ConvTranspose(k, strides=s, padding="SAME")` on NCHW.

    Flax's transposed conv equals torch `conv_transpose2d(stride=s,
    padding=0)` with the kernel flipped in space, laid out (I, O, kH, kW),
    and the output cropped to [:s*H, :s*W]. The weight here is stored already
    flipped; models/convert.py does the flip.
    """

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 2,
                 dtype=torch.bfloat16):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        I, O, kh, kw = self.weight.shape
        lecun_normal_(self.weight, I * kh * kw, generator)

    def forward(self, x):
        H, W = x.shape[2:]
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                               stride=self.stride)
        return y[:, :, :self.stride * H, :self.stride * W]


class Dense(nn.Module):
    """Flax `nn.Dense` on the last axis: weight (O, I)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class BatchNorm(nn.Module):
    """Flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)` over
    `channel_dim`: (x - mean) * scale * rsqrt(var + eps) + bias in f32 (in
    f64 for an f64 input). Returns that dtype.

    Eval mode reads the running statistics. Train mode takes the statistics
    of the batch over every other axis, in f32, with Flax's fast variance
    var = max(0, mean(x^2) - mean(x)^2); it normalises with that biased
    variance and stores it: running = 0.9 * running + 0.1 * batch, in place
    and outside the graph. (`F.batch_norm` stores the unbiased variance, and
    its `momentum` is one minus Flax's.)

    `group`: a process group of more than one rank (set by
    parallel/mesh.py::replicate_module), or None. With one, train mode takes
    the statistics over every rank's batch, as the JAX package's global view
    does: the per-channel sums of x and x^2 and the count go through one
    autograd-aware all-reduce, whose backward all-reduces their gradient, so
    the running statistics come out equal on every rank.
    (`nn.SyncBatchNorm` would not convert this class.)"""

    momentum = 0.9

    def __init__(self, num: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(num))
        self.bias = nn.Parameter(torch.zeros(num))
        self.register_buffer("running_mean", torch.zeros(num))
        self.register_buffer("running_var", torch.ones(num))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def folded(self):
        """(scale, bias) f32 with BN(x) = x * scale + bias, from the running
        statistics."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale

    def forward(self, x, channel_dim: int = 1):
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        dtype = torch.promote_types(x.dtype, torch.float32)        # f32 at least, as Flax
        if not self.training:
            # one expression: no name keeps the f32 copy of x alive past the
            # subtraction (a third of the peak memory of a serving batch)
            mul = (torch.rsqrt(self.running_var + self.eps) * self.weight).view(shape)
            return (x.to(dtype) - self.running_mean.view(shape)) * mul + self.bias.view(shape)
        x = x.to(dtype)
        dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
        if self.group is None:
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        else:
            mean, var = self._global_statistics(x, dims)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        mul = (torch.rsqrt(var + self.eps) * self.weight).view(shape)
        return (x - mean.view(shape)) * mul + self.bias.view(shape)

    def _global_statistics(self, x, dims):
        """(mean, var) over `dims` of every rank's x, Flax's formula."""
        from torch.distributed.nn.functional import all_reduce
        C = self.weight.shape[0]
        count = x.new_full((1,), float(x.numel() // C))
        stats = all_reduce(torch.cat([x.sum(dims), (x * x).sum(dims), count]),
                           group=self.group)
        mean = stats[:C] / stats[-1]
        var = (stats[C:2 * C] / stats[-1] - mean * mean).clamp_min(0.0)
        return mean, var


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm(epsilon=1e-6, dtype=float32)` over `channel_dim`:
    f32 statistics (f64 for an f64 input) with the fast variance
    max(0, E[x^2] - E[x]^2), then (x - mean) * rsqrt(var + eps) * scale +
    bias in that dtype, which it returns; the caller casts back."""

    def __init__(self, num: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num))
        self.bias = nn.Parameter(torch.zeros(num))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x, channel_dim: int = 1):
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(channel_dim, keepdim=True)
        var = ((x * x).mean(channel_dim, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return (x - mean) * mul + self.bias.view(shape)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm (f32) -> cast to dtype -> activation."""

    def __init__(self, cin: int, features: int, kernel=3, stride: int = 1,
                 act: Optional[Callable] = F.relu, use_bias: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.act = act
        self.dtype = dtype
        self.conv = Conv2d(cin, features, kernel, stride, bias=use_bias, dtype=dtype)
        self.bn = BatchNorm(features)

    def forward(self, x):
        x = self.bn(self.conv(x)).to(self.dtype)
        return self.act(x) if self.act is not None else x


class BasicBlock(nn.Module):
    """ResNet-v1 basic block (two 3x3 convs), as in the HRNet branches."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = ConvBNAct(cin, features, 3, stride, F.relu, dtype=dtype)
        self.conv2 = ConvBNAct(features, features, 3, 1, None, dtype=dtype)
        # Flax adds the projection when the residual's shape differs
        if cin != features or stride != 1:
            self.downsample = ConvBNAct(cin, features, 1, stride, None, dtype=dtype)
        else:
            self.downsample = None

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class Bottleneck(nn.Module):
    """ResNet bottleneck (1x1 -> 3x3 -> 1x1, expansion 4)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 expansion: int = 4, dtype=torch.bfloat16):
        super().__init__()
        out = features * expansion
        self.conv1 = ConvBNAct(cin, features, 1, 1, F.relu, dtype=dtype)
        self.conv2 = ConvBNAct(features, features, 3, stride, F.relu, dtype=dtype)
        self.conv3 = ConvBNAct(features, out, 1, 1, None, dtype=dtype)
        if cin != out or stride != 1:
            self.downsample = ConvBNAct(cin, out, 1, stride, None, dtype=dtype)
        else:
            self.downsample = None

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling of NCHW, align_corners=True (the JAX package's
    matmul form is a TPU workaround for the same weights)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
