"""Plain PyTorch reference of the CheckerPose network, in float32.

A frozen, self-contained copy of the published architecture as the benchmark
runs it: the features of the backbone the configuration names (the module
`backbones/<name>.py`, found by `backbones.load`), the init net (1x1 conv
to one 8x8 map a keypoint, two EdgeConvs, a dense head), then one up-block
and one refine block a stage (patch-embed gather at the current cells, two
dense layers, three EdgeConvs, a query MLP) and the seg head. Parameter
names follow the measured program's `state_dict`, so the benchmark loads
the weights it made into both.

It imports nothing but torch and its backbones. Every product is f32 with
TF32 off (`set_reference_flags`). Two things the program does not do:

* `forward(..., forced=...)` reads the refine stages' cells and RoI mask
  from given ids (the served ones) instead of its own decisions, so every
  bit's logit is the reference's answer to the question the program
  answered (as a language model's reference scores the served tokens);
* `set_quant(net, "bf16")` rounds every product's operands (and, in a
  backward pass, their gradients) to bfloat16, the configuration's
  precision, which scales what rounding alone moves; `"fp8"` to float8
  (e4m3 forward, e5m2 backward, per-tensor scales): the control that a
  comparison must reject.

EdgeConv is written in its per-node form, [x_j - x_i, x_i] @ [W1; W2] =
x_j @ W1 + x_i @ (W2 - W1), which is the same function with K times fewer
operations; its max over K runs on the edges. Train mode takes batch
statistics in every BatchNorm (the fast variance max(0, E[x^2] - E[x]^2)),
over (B, N, K) for an EdgeConv's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from posebench.reference import backbones


def set_reference_flags() -> None:
    """True f32 products on the card: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _Round(torch.autograd.Function):
    """Operands rounded to a narrower type on the way in, and their
    gradients on the way back: bfloat16 both ways, or float8 e4m3 forward and
    e5m2 backward, each float8 tensor under a per-tensor scale (amax to the
    type's largest finite value), as float8 training keeps them."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return _narrow(t, torch.float8_e4m3fn if kind == "fp8" else torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, torch.float8_e5m2 if ctx.kind == "fp8" else torch.bfloat16), None


def _narrow(t: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return t.to(dtype).to(t.dtype)
    amax = t.abs().amax().clamp_min(1e-30)
    s = torch.finfo(dtype).max / amax
    return (t * s).to(dtype).to(t.dtype) / s


def set_checkpointing(model: nn.Module, on: bool) -> None:
    """Recompute each block's activations in the backward pass (`run`)."""
    for m in model.modules():
        m.ckpt = on


def run(owner: nn.Module, fn, *args):
    """fn(*args), recomputed in the backward pass when `owner` checkpoints."""
    if getattr(owner, "ckpt", False) and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Q(nn.Module):
    """Base of every layer with a product: `self.quant` picks the operands'
    rounding (`_Round`): None for float32, "bf16" for the configuration's
    precision, "fp8" for the control."""
    quant: Optional[str] = None

    def q(self, t):
        return t if self.quant is None else _Round.apply(t, self.quant)


def set_quant(model: nn.Module, quant: Optional[str]) -> None:
    for m in model.modules():
        if isinstance(m, Q):
            m.quant = quant


def same_pads(n: int, k: int, s: int):
    """(lo, hi) padding of "SAME": ceil(n / s) outputs, the odd pixel at the end."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2d(Q):
    def __init__(self, cin, cout, k, stride=1, padding="SAME", bias=False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        k = self.weight.shape[-1]
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], k, self.stride)
            pw = same_pads(x.shape[3], k, self.stride)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        else:
            x = F.pad(x, (self.padding,) * 4)
        return F.conv2d(self.q(x), self.q(self.weight), self.bias, stride=self.stride)


class ConvTranspose2d(Q):
    """3x3, stride 2, "SAME": torch's transposed conv (weight (I, O, k, k),
    stored flipped as the program stores it) cropped to 2H x 2W."""

    def __init__(self, cin, cout, k=3, stride=2):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))

    def forward(self, x):
        H, W = x.shape[2:]
        y = F.conv_transpose2d(self.q(x), self.q(self.weight), stride=self.stride)
        return y[:, :, :self.stride * H, :self.stride * W]


class Dense(Q):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class BatchNorm(nn.Module):
    """scale * (x - mean) / sqrt(var + 1e-5) + bias over `channel_dim`; eval
    mode reads the running statistics, train mode the batch's."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))
        self.register_buffer("running_mean", torch.empty(n))
        self.register_buffer("running_var", torch.empty(n))

    def forward(self, x, channel_dim=1):
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        if self.training:
            dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + 1e-5)
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class ConvBNAct(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, relu=True):
        super().__init__()
        self.relu = relu
        self.conv = Conv2d(cin, cout, k, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = ConvBNAct(cin, cout, 3, stride)
        self.conv2 = ConvBNAct(cout, cout, 3, 1, relu=False)
        self.downsample = (ConvBNAct(cin, cout, 1, stride, relu=False)
                           if cin != cout or stride != 1 else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + r)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride=1):
        super().__init__()
        out = 4 * width
        self.conv1 = ConvBNAct(cin, width, 1)
        self.conv2 = ConvBNAct(width, width, 3, stride)
        self.conv3 = ConvBNAct(width, out, 1, relu=False)
        self.downsample = (ConvBNAct(cin, out, 1, stride, relu=False)
                           if cin != out or stride != 1 else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + r)


def gather_rows(y, knn):
    """y (B, N, C) at a static (N, K) or per-sample (B, N, K) graph -> (B, N, K, C)."""
    if knn.dim() == 2:
        return y[:, knn.long()]
    B, N, K = knn.shape
    b = torch.arange(B, device=y.device)[:, None, None]
    return y[b, knn.long()]


class EdgeConv(nn.Module):
    """max_K leaky(BN([x_j - x_i, x_i] @ W)), W = conv.weight^T (2C, C')."""

    def __init__(self, c, cout, slope=0.2):
        super().__init__()
        self.slope = slope
        self.conv = Dense(2 * c, cout, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, knn):
        C = x.shape[-1]
        w = self.conv.weight                                   # (C', 2C)
        w1, w2 = w[:, :C], w[:, C:]
        q = self.conv.q
        y = F.linear(q(x), q(w1))                              # x_j's part
        z = F.linear(q(x), q(w2 - w1))                         # x_i's part
        e = gather_rows(y, knn) + z[:, :, None, :]             # (B, N, K, C')
        e = F.leaky_relu(self.bn(e, channel_dim=-1), self.slope)
        return e.amax(dim=2)


class InitNet(nn.Module):
    def __init__(self, npoint, backbone, res_log2=3, num_graph=2, slope=0.2):
        super().__init__()
        self.num_graph = num_graph
        backbone_module = backbones.load(backbone)
        self.backbone = backbone_module.Features()
        self.conv1x1_0 = Conv2d(backbone_module.DIMS[-1], npoint, 1, bias=True)
        for i in range(num_graph):
            self.add_module(f"graph_{i}", EdgeConv(64, 64, slope))
        self.mlp = Dense(64, 1 + 2 * res_log2)

    def forward(self, x, knn):
        feats = self.backbone(x)
        m = self.conv1x1_0(feats[-1])
        B, N = m.shape[:2]
        resp = g = m.reshape(B, N, -1)                         # each keypoint's 8x8 map
        for i in range(self.num_graph):
            g = run(self, getattr(self, f"graph_{i}"), g, knn)
        return self.mlp(g), feats, g, resp


class UpBlock(nn.Module):
    def __init__(self, cin, nf=256, convtrans=False):
        super().__init__()
        self.convtrans = convtrans
        if convtrans:
            self.convT = ConvTranspose2d(cin, nf)
            self.bn0 = BatchNorm(nf)
            self.conv1 = Conv2d(nf, nf, 3)
        else:
            self.conv1 = Conv2d(cin, nf, 3)
        self.bn1 = BatchNorm(nf)
        self.conv2 = Conv2d(nf, nf, 3)
        self.bn2 = BatchNorm(nf)

    def forward(self, x):
        if self.convtrans:
            x = F.relu(self.bn0(self.convT(x)))
        else:
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class RefineBlock(nn.Module):
    def __init__(self, cin_img, graph_dim, query=(256, 256, 64), local_k=2, slope=0.01,
                 num_graph=3, graph_slope=0.2):
        super().__init__()
        C0 = query[0]
        self.k, self.slope, self.num_graph, self.n_query = local_k, slope, num_graph, len(query) - 1
        self.index2feat = nn.Module()
        self.index2feat.patch_conv = Conv2d(cin_img, C0 // 4, local_k, padding=local_k - 1,
                                            bias=True)
        self.pre_graph_0 = Dense(C0 + graph_dim, C0)
        self.pre_graph_1 = Dense(C0, C0)
        for i in range(num_graph):
            self.add_module(f"graph_{i}", EdgeConv(C0, C0, graph_slope))
        d = C0
        for i, o in enumerate(query[1:]):
            self.add_module(f"query_{i}", Dense(d, o))
            d = o
        self.query_out = Dense(d, 2)

    def local_features(self, img, x_id, y_id):
        """The patch embeddings at (2u, 2v), (2u+k, 2v), (2u, 2v+k),
        (2u+k, 2v+k) of each keypoint's cell, concatenated: (B, N, 4E)."""
        k = self.k
        p = self.index2feat.patch_conv(img)                      # (B, E, H', W')
        B, E, Hp, Wp = p.shape
        by, bx = 2 * y_id.long(), 2 * x_id.long()
        taps = [(by, bx), (by + k, bx), (by, bx + k), (by + k, bx + k)]
        flat = p.reshape(B, E, Hp * Wp)
        outs = [flat.gather(2, (r * Wp + c)[:, None, :].expand(B, E, r.shape[1]))
                for r, c in taps]                                 # each (B, E, N)
        return torch.stack(outs, dim=2).permute(0, 3, 2, 1).reshape(B, -1, 4 * E)

    def forward(self, img, graph_feat, roi, x_id, y_id, knn):
        local = self.local_features(img, x_id, y_id) * roi
        x = torch.cat([local, graph_feat], dim=-1)
        x = F.leaky_relu(self.pre_graph_0(x), self.slope)
        x = F.leaky_relu(self.pre_graph_1(x), self.slope)
        for i in range(self.num_graph):
            x = getattr(self, f"graph_{i}")(x, knn)
        q = x
        for i in range(self.n_query):
            q = F.leaky_relu(getattr(self, f"query_{i}")(q), self.slope)
        return self.query_out(q), x


def bits_to_ids(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} (B, N, L), most significant first -> ids (B, N) int64."""
    L = bits.shape[-1]
    w = 2 ** torch.arange(L - 1, -1, -1, device=bits.device)
    return (bits.long() * w).sum(-1)


class PoseNet(nn.Module):
    """The published network (res_log2 6: 8x8 codes refined three times to
    64x64), with `cfg` as in a configuration file's `model` group."""

    def __init__(self, npoint=512, backbone="hrnet_w18", res_log2=6, num_graph_module=3,
                 init_num_graph_module=2, local_k=2, leaky_slope=0.01,
                 graph_leaky_slope=0.2, num_filters=256, query_dims=(256, 256, 64),
                 seg_output_dim=2):
        super().__init__()
        self.res_log2 = res_log2
        self.init_net = InitNet(npoint, backbone, 3, init_num_graph_module, graph_leaky_slope)
        dims = backbones.load(backbone).DIMS
        for i in range(res_log2 - 3):
            cin = dims[-1] if i == 0 else num_filters + dims[-i - 1]
            self.add_module(f"up_{i}", UpBlock(cin, num_filters, i == 0))
            self.add_module(f"refine_{i}", RefineBlock(
                num_filters, 64 if i == 0 else query_dims[0], tuple(query_dims), local_k,
                leaky_slope, num_graph_module, graph_leaky_slope))
        self.seg_block = Conv2d(num_filters, seg_output_dim, 1, bias=True)

    def forward(self, img, knn, stage: Optional[int] = None,
                forced: Optional[Dict[str, torch.Tensor]] = None):
        """img (B, H, W, 3) normalised; knn (N, K) or per-sample (B, N, K).

        forced: {"x_id", "y_id"} (B, N) at the final resolution and "roi"
        (B, N) {0,1}: the refine stages gather at these cells (stage i at
        their top 3 + i bits) under this RoI mask.

        Returns roi_logit (B, N), x_logits / y_logits (B, N, 3 + stage),
        seg_logits (B, h, w, 2), x_id / y_id (B, N), and in train mode the
        init net's response maps `resp_map` (B, N, 64)."""
        stage = self.res_log2 - 3 if stage is None else stage
        bits, feats, graph_feat, resp = self.init_net(img.permute(0, 3, 1, 2), knn)
        roi_logit, x_logits, y_logits = bits[..., 0], bits[..., 1:4], bits[..., 4:7]
        if forced is None:
            roi = (roi_logit > 0).float()
            x_id, y_id = bits_to_ids(x_logits > 0), bits_to_ids(y_logits > 0)
        else:
            roi = forced["roi"].float()
        img_feat = feats[-1]
        for i in range(stage):
            if i > 0:
                img_feat = torch.cat([img_feat, feats[-i - 1]], dim=1)
            img_feat = run(self, getattr(self, f"up_{i}"), img_feat)
            if forced is not None:
                shift = stage - i
                x_id, y_id = forced["x_id"].long() >> shift, forced["y_id"].long() >> shift
            new, graph_feat = run(self, getattr(self, f"refine_{i}"),
                                  img_feat, graph_feat, roi[..., None], x_id, y_id, knn)
            x_logits = torch.cat([x_logits, new[..., 0:1]], -1)
            y_logits = torch.cat([y_logits, new[..., 1:2]], -1)
            x_id = 2 * x_id + (new[..., 0] > 0).long()
            y_id = 2 * y_id + (new[..., 1] > 0).long()
        out = {"roi_logit": roi_logit, "x_logits": x_logits, "y_logits": y_logits,
               "seg_logits": self.seg_block(img_feat).permute(0, 2, 3, 1),
               "x_id": x_id, "y_id": y_id}
        if self.training:
            out["resp_map"] = resp
        return out


def build(cfg: Dict, device="cpu") -> PoseNet:
    """The reference network a configuration file's `model` group describes,
    uninitialised (load the benchmark's weights into it), in eval mode."""
    net = PoseNet(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()})
    return net.to(device).eval()
