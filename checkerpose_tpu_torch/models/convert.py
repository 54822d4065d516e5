"""Flax `variables` <-> torch `state_dict` for the port's modules.

Module names in the port follow the Flax tree, so a leaf's path maps to a
state_dict key by joining with "." and renaming the leaf. Inputs are nested
mappings of numpy arrays (no jax import). Layout rules (the inverse of
checkerpose_tpu/models/convert.py's torch -> Flax rules):

  Flax Conv kernel (kH, kW, I, O)          -> torch weight (O, I, kH, kW)
  Flax ConvTranspose kernel (kH, kW, I, O) -> torch weight (I, O, kH, kW),
                                              flipped in space
  Flax Dense kernel (I, O)                 -> torch weight (O, I)
  bias                                     -> bias
  BatchNorm / LayerNorm scale / bias       -> weight / bias
  ConvNeXt layer scale gamma               -> gamma
  batch_stats mean / var                   -> running_mean / running_var

Every leaf is consumed in both directions; an unknown leaf raises. Going
back, a rank-1 `weight` is a BatchNorm's scale when its running statistics
sit beside it, else a LayerNorm's.

The optimizer's state crosses too: optax Adam's `(count, mu, nu)`, given as
numpy trees with the params' structure, <-> `torch.optim.Adam.state_dict()`
(`adam_state_to_torch`, `adam_state_to_flax`), so that a run can be compared
with the JAX package beyond its first step. `graft_backbone` puts a
pretrained backbone's entries into a model's state_dict.

A timm or torchvision checkpoint maps onto a backbone too:
`load_torch_state_dict` reads the file, `CONVERTERS[name]` renames its
entries to the port's (the layouts agree, so no value changes) and
`graft_backbone` puts them in. The classification-only tensors are ignored.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# the one ConvTranspose of the model (models/posenet.py::UpBlock)
_CONV_T = "convT"


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _tensor(v: np.ndarray) -> torch.Tensor:
    """A contiguous f32 tensor that owns its memory (the source may be a
    read-only view of a device array)."""
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


def flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} -> state_dict of f32 tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _leaves(variables.get("params", {})):
        leaf = path[-1]
        if leaf == "kernel":
            if v.ndim == 4 and path[-2:-1] == (_CONV_T,):
                v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
            elif v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            elif v.ndim == 2:
                v = v.T
            else:
                raise ValueError(f"kernel of rank {v.ndim} at {'/'.join(path)}")
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("bias", "gamma"):
            name = leaf
        else:
            raise KeyError(f"unknown params leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = _tensor(v)
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, v in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in stat_names:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (stat_names[path[-1]],))
        sd[key] = _tensor(v)
    return sd


def _put(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """state_dict -> {"params": ..., "batch_stats": ...} of numpy f32."""
    params: dict = {}
    stats: dict = {}
    keys = set(state_dict)
    for key, t in state_dict.items():
        v = t.detach().cpu().float().numpy()
        *path, leaf = key.split(".")
        path = tuple(path)
        is_bn = ".".join(path + ("running_mean",)) in keys
        if leaf == "running_mean":
            _put(stats, path + ("mean",), v)
        elif leaf == "running_var":
            _put(stats, path + ("var",), v)
        elif leaf == "weight" and (is_bn or v.ndim == 1):
            _put(params, path + ("scale",), v)
        elif leaf == "weight":
            if v.ndim == 4 and path[-1:] == (_CONV_T,):
                v = np.transpose(v, (2, 3, 0, 1))[::-1, ::-1]
            elif v.ndim == 4:
                v = np.transpose(v, (2, 3, 1, 0))
            elif v.ndim == 2:
                v = v.T
            else:
                raise ValueError(f"weight of rank {v.ndim} at {key}")
            _put(params, path + ("kernel",), np.ascontiguousarray(v))
        elif leaf in ("bias", "gamma"):
            _put(params, path + (leaf,), v)
        else:
            raise KeyError(f"unknown state_dict entry {key}")
    return {"params": params, "batch_stats": stats}


def _param_names(module: torch.nn.Module):
    return [name for name, _ in module.named_parameters()]


def adam_state_to_torch(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        count: int, mu: Mapping, nu: Mapping) -> None:
    """Load optax Adam's state into `optimizer` (built over
    `module.parameters()`, one param group): `count` updates made, first and
    second moments `mu` / `nu` as Flax params trees of numpy arrays. A
    two-phase optimizer (train/state.py::TwoPhaseAdam) also gets its count."""
    m_sd = flax_to_torch({"params": mu})
    v_sd = flax_to_torch({"params": nu})
    names = _param_names(module)
    if set(names) != set(m_sd) or set(names) != set(v_sd):
        raise KeyError(f"moments do not match the module's parameters: "
                       f"{sorted(set(names) ^ set(m_sd))[:5]}")
    sd = optimizer.state_dict()
    if len(sd["param_groups"]) != 1 or len(sd["param_groups"][0]["params"]) != len(names):
        raise ValueError("the optimizer must hold module.parameters() in one param group")
    sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": m_sd[n],
                       "exp_avg_sq": v_sd[n]} for i, n in enumerate(names)}
    if "count" in sd["param_groups"][0]:
        sd["param_groups"][0]["count"] = int(count)
    optimizer.load_state_dict(sd)


def adam_state_to_flax(module: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """(count, mu, nu) of optax Adam out of `optimizer`: the number of
    updates made and the two moments as Flax params trees of numpy f32. An
    optimizer that has made no update gives count 0 and zero moments."""
    names = _param_names(module)
    state = optimizer.state_dict()["state"]
    params = dict(module.named_parameters())
    count, m_sd, v_sd = 0, {}, {}
    for i, n in enumerate(names):
        s = state.get(i)
        if s is None:
            m_sd[n] = v_sd[n] = torch.zeros_like(params[n])
        else:
            count = int(s["step"])
            m_sd[n], v_sd[n] = s["exp_avg"], s["exp_avg_sq"]
    # BatchNorm weights are told from LayerNorm weights by their running statistics
    stats = {k: v for k, v in module.state_dict().items() if k.endswith("running_mean")}
    return (count, torch_to_flax({**m_sd, **stats})["params"],
            torch_to_flax({**v_sd, **stats})["params"])


def graft_backbone(state_dict: Mapping[str, torch.Tensor],
                   backbone: Mapping[str, torch.Tensor],
                   into: str = "init_net") -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` with the backbone's entries replaced by
    `backbone` (keys relative to the backbone, e.g. a checkpoint's
    `backbone.*` entries with the prefix taken off), under `<into>.backbone.`,
    or `backbone.` when `into` is empty (an InitNet's own state_dict). Every
    entry is validated first: a key the model lacks raises KeyError, a shape
    that differs ValueError (the JAX package's leaf-by-leaf check)."""
    prefix = f"{into}.backbone." if into else "backbone."
    for k, v in backbone.items():
        if prefix + k not in state_dict:
            raise KeyError(f"converted key {prefix}{k} missing in model")
        if tuple(state_dict[prefix + k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {prefix}{k}: "
                             f"{tuple(state_dict[prefix + k].shape)} vs {tuple(v.shape)}")
    out = dict(state_dict)
    for k, v in backbone.items():
        out[prefix + k] = v.to(dtype=state_dict[prefix + k].dtype)
    return out


# ---------------------------------------------------------------------------
# timm / torchvision checkpoints -> the port's backbone state_dict
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint file, unwrapped from `state_dict` and then
    `model_state_dict` where it has them. Loads with `weights_only=True`: a
    file that pickles other objects than tensors and containers raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().contiguous().clone()
    return _tensor(v)


_BN_ENTRIES = ("weight", "bias", "running_mean", "running_var")


def _convbn(sd: Mapping, conv_key: str, bn_key: str) -> Dict[str, torch.Tensor]:
    """One ConvBNAct's entries (relative to it) from a conv and its BatchNorm."""
    out = {"conv.weight": _f32(sd[conv_key + ".weight"])}
    out.update({f"bn.{e}": _f32(sd[f"{bn_key}.{e}"]) for e in _BN_ENTRIES})
    return out


def _block(sd: Mapping, pre: str, n_convs: int) -> Dict[str, torch.Tensor]:
    """A timm BasicBlock (2 convs) or Bottleneck (3) `{pre}.conv{i}/bn{i}
    [.downsample.0/1]` -> models/layers.py's block (conv{i}, downsample)."""
    out = {}
    for i in range(1, n_convs + 1):
        out.update(_prefixed(f"conv{i}", _convbn(sd, f"{pre}.conv{i}", f"{pre}.bn{i}")))
    if f"{pre}.downsample.0.weight" in sd:
        out.update(_prefixed("downsample", _convbn(sd, f"{pre}.downsample.0",
                                                   f"{pre}.downsample.1")))
    return out


def _prefixed(name: str, entries: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{name}.{k}": v for k, v in entries.items()}


def convert_resnet34(sd: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision / timm ResNet-34 entries (conv1/bn1, layer{s}.{b}.conv{i}/
    bn{i}, downsample.0/1; `fc` ignored) -> models/resnet.py's state_dict,
    keys relative to the backbone."""
    out = _prefixed("stem", _convbn(sd, "conv1", "bn1"))
    for s, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            out.update(_prefixed(f"layer{s + 1}_block{b}", _block(sd, f"layer{s + 1}.{b}", 2)))
    return out


def convert_hrnet_w18(sd: Mapping) -> Dict[str, torch.Tensor]:
    """timm `hrnet_w18` (HighResolutionNet) entries -> models/hrnet.py's
    state_dict, keys relative to the backbone. timm's layout:
      conv1/bn1, conv2/bn2                       stem, two stride-2 3x3s
      layer1.{k}                                 4 Bottlenecks (64 -> 256)
      transition{s}.{b}[.0].{0,1}                adapt convs / new-branch conv
      stage{s}.{m}.branches.{b}.{k}              4 BasicBlocks per branch
      stage{s}.{m}.fuse_layers.{i}.{j}[...]      1x1+up (j>i) / 3x3-s2 chain (j<i)
      incre_modules.{b}.0                        Bottleneck widening heads
    The classification-only entries (downsamp_modules, final_layer,
    classifier) are ignored."""
    out = _prefixed("stem1", _convbn(sd, "conv1", "bn1"))
    out.update(_prefixed("stem2", _convbn(sd, "conv2", "bn2")))
    for k in range(4):
        out.update(_prefixed(f"layer1_block{k}", _block(sd, f"layer1.{k}", 3)))
    for stage, modules in enumerate((1, 4, 3)):          # timm stages 2, 3, 4
        n_br = stage + 2
        tr = f"transition{stage + 1}"
        # an adapt conv exists only where the width changes; the new branch
        # is a nested Sequential (one more ".0")
        for b in range(n_br - 1):
            if f"{tr}.{b}.0.weight" in sd:
                out.update(_prefixed(f"t{stage}_adapt{b}",
                                     _convbn(sd, f"{tr}.{b}.0", f"{tr}.{b}.1")))
        out.update(_prefixed(f"t{stage}_new", _convbn(sd, f"{tr}.{n_br - 1}.0.0",
                                                      f"{tr}.{n_br - 1}.0.1")))
        for m in range(modules):
            pre, name = f"stage{stage + 2}.{m}", f"stage{stage + 2}_module{m}"
            for b in range(n_br):
                for k in range(4):
                    out.update(_prefixed(f"{name}.branch{b}_block{k}",
                                         _block(sd, f"{pre}.branches.{b}.{k}", 2)))
            for i in range(n_br):
                for j in range(n_br):
                    fl = f"{pre}.fuse_layers.{i}.{j}"
                    if j > i:
                        out.update(_prefixed(f"{name}.fuse.up_{j}_to_{i}",
                                             _convbn(sd, f"{fl}.0", f"{fl}.1")))
                    for step in range(i - j):
                        out.update(_prefixed(f"{name}.fuse.down_{j}_to_{i}_{step}",
                                             _convbn(sd, f"{fl}.{step}.0", f"{fl}.{step}.1")))
    for b in range(4):
        out.update(_prefixed(f"incre{b}", _block(sd, f"incre_modules.{b}.0", 3)))
    return out


CONVERTERS = {"resnet34": convert_resnet34, "hrnet_w18": convert_hrnet_w18}
