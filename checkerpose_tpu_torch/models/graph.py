"""EdgeConv over a keypoint KNN graph (counterpart of
checkerpose_tpu/models/graph.py::EdgeConv).

concat([x_j - x_i, x_i]) -> Dense (no bias) -> BN -> LeakyReLU -> max_K.
Features are channel-last (B, N, C), like the JAX package. The Dense kernel
keeps the Flax name `conv`. `train()` / `eval()` and the graph's rank decide
the path:

  eval, static (N, K) graph
         the fused op (ops/edgeconv.py::edgeconv_fused, a CUDA kernel on the
         card) with BN's running statistics folded into a scale and a bias;
  eval, per-sample (B, N, K) graph (the multi-object variant)
         ops/edgeconv.py::edgeconv_eval_per_sample, plain PyTorch with BN
         unfolded, the path the JAX package takes for such an index (its
         kernel bakes in one static graph);
  train, either graph
         the per-node form in plain PyTorch (ops/edgeconv.py::edgeconv_train)
         with batch-statistics BN over the whole (B, N, K, C') edge tensor,
         as the JAX package trains outside its kernel; autograd gives the
         backward.

In eval mode the folded and packed weights are computed once and kept. The
key holds each source tensor's identity, storage address and version counter,
so they are rebuilt when a parameter or BN statistic was written in place
(`load_state_dict`, an optimizer step) or replaced (`load_state_dict(assign=
True)`, a new `nn.Parameter`); `train()` and anything that goes through
`_apply` (`.to()`, `.cuda()`, `.float()`) drop them. Inference tensors (a
model built or loaded under `torch.inference_mode()`) carry no version
counter, so a module that holds one folds on every forward. A write that
hides from the version counter (`param.data.copy_(...)`) is not seen: call
`train(False)` after it.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from checkerpose_tpu_torch.models.layers import BatchNorm, Dense
from checkerpose_tpu_torch.ops.edgeconv import (edgeconv_eval_per_sample, edgeconv_fused,
                                                edgeconv_train, pack_edgeconv_weights)


class EdgeConv(nn.Module):
    def __init__(self, cin: int, features: int, leaky_slope: float = 0.2,
                 dtype=torch.bfloat16):
        super().__init__()
        self.leaky_slope = leaky_slope
        self.dtype = dtype
        self.conv = Dense(2 * cin, features, bias=False, dtype=dtype)
        self.bn = BatchNorm(features)
        self._fused_cache = None
        self.folds = 0                   # times the weights were folded and packed

    def split_weights(self):
        """(w1, w2m1): with the Flax kernel W = [W1; W2] (2C, C'), w1 = W1
        and w2m1 = W2 - W1 (difference taken in f32, then cast)."""
        k = self.conv.weight.float().t()
        C = k.shape[0] // 2
        return k[:C].to(self.dtype).contiguous(), (k[C:] - k[:C]).to(self.dtype).contiguous()

    def folded(self):
        """(w1, w2m1, scale, bias) of the fused op: the split weights and BN
        folded to an f32 scale and bias."""
        scale, bias = self.bn.folded()
        return *self.split_weights(), scale.contiguous(), bias.contiguous()

    def fused_args(self):
        """`folded()` plus the weights packed for the tensor-core kernel
        (bf16 only, else None), kept across eval forwards."""
        sources = (self.conv.weight, self.bn.weight, self.bn.bias,
                   self.bn.running_mean, self.bn.running_var)
        cacheable = not self.training and not any(t.is_inference() for t in sources)
        key = (self.dtype, self.conv.weight.device,
               *((t.data_ptr(), t._version) for t in sources)) if cacheable else None
        if cacheable and self._fused_cache is not None:
            kept_sources, kept_key, kept = self._fused_cache
            # the kept references keep a replaced tensor's identity from being reused
            if kept_key == key and all(a is b for a, b in zip(kept_sources, sources)):
                return kept
        with torch.no_grad():
            w1, w2m1, scale, bias = self.folded()
            packed = pack_edgeconv_weights(w1, w2m1) if self.dtype == torch.bfloat16 else None
        self.folds += 1
        args = (w1, w2m1, scale, bias, packed)
        self._fused_cache = (sources, key, args) if cacheable else None
        return args

    def train(self, mode: bool = True):
        self._fused_cache = None
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._fused_cache = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x, knn_idx):
        """x (B, N, C); knn_idx static (N, K) or per-sample (B, N, K) int32
        on x's device. A per-sample graph neither folds nor touches the kept
        fused weights."""
        if knn_idx.dim() not in (2, 3):
            raise ValueError(f"knn_idx must be (N, K) or (B, N, K), got {tuple(knn_idx.shape)}")
        x = x.to(self.dtype)
        if knn_idx.dim() == 3:
            w1, w2m1 = self.split_weights()
            fn = edgeconv_train if self.training else edgeconv_eval_per_sample
            return fn(x, knn_idx, w1, w2m1, self.bn, self.leaky_slope)
        if self.training:
            w1, w2m1 = self.split_weights()
            return edgeconv_train(x, knn_idx, w1, w2m1, self.bn, self.leaky_slope)
        w1, w2m1, scale, bias, packed = self.fused_args()
        return edgeconv_fused(x.contiguous(), knn_idx, w1, w2m1,
                              scale, bias, self.leaky_slope, packed=packed)
