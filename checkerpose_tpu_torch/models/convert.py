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
  BatchNorm scale / bias                   -> weight / bias
  batch_stats mean / var                   -> running_mean / running_var

Every leaf is consumed in both directions; an unknown leaf raises.

The optimizer's state crosses too: optax Adam's `(count, mu, nu)`, given as
numpy trees with the params' structure, <-> `torch.optim.Adam.state_dict()`
(`adam_state_to_torch`, `adam_state_to_flax`), so that a run can be compared
with the JAX package beyond its first step. `graft_backbone` puts a
pretrained backbone's entries into a model's state_dict.
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
        elif leaf == "bias":
            name = "bias"
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
        elif leaf == "weight" and is_bn:
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
        elif leaf == "bias":
            _put(params, path + ("bias",), v)
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
    # BatchNorm weights are told from kernels by their running statistics
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
