"""Data parallelism over processes (counterpart of
checkerpose_tpu/parallel/mesh.py).

One process per card, started by torchrun (or anything that sets its
environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Each
process holds a whole replica of the module and its own rows of every global
batch. The JAX package writes its steps in global view and lets XLA insert the
all-reduces; here they are explicit, and the arithmetic is the same:

  * BatchNorm takes its train-mode statistics over the global batch
    (models/layers.py::BatchNorm with a process group: sync-BN, as JAX's is by
    construction);
  * every loss term is normalized by its count over the global batch, so each
    rank computes its part of the global loss and the parts add up to it
    (losses/__init__.py::global_sum, global_mean);
  * every random draw of a step is made at the global batch's shape from a
    generator seeded alike on every rank, each rank keeping its own rows;
  * the gradients are summed over the ranks before the optimizer update
    (train/steps.py::_update).

A W-rank step thus equals the one-process step on the concatenated batch.

The `Mesh` record stands for JAX's 2-axis `(data, model)` mesh. The model axis
is sized 1 there (no tensor parallelism at this model's scale) and has no
counterpart here: `make_mesh` refuses any other size. JAX's `data_sharding`
and `replicated` are sharding specs for `jax.device_put`; torch has no such
object, and their roles are `shard_batch` (this rank's rows) and
`replicate_module` (rank 0's parameters on every rank).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from checkerpose_tpu_torch.device import resolve_device
from checkerpose_tpu_torch.models.layers import BatchNorm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: its rank, the world
    size, its device, the backend and the process group (None for one
    process started without torchrun's environment)."""
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    @property
    def batch_group(self):
        """The group that reductions over the batch axis go over: None where
        the batch is whole on this process (world size 1)."""
        return self.group if self.world > 1 else None

    @property
    def lead(self) -> bool:
        """True on the rank that writes checkpoints, logs and evaluates."""
        return self.rank == 0


def make_mesh(device="cuda", n_model: int = 1,
              timeout: datetime.timedelta = datetime.timedelta(minutes=30)) -> Mesh:
    """The mesh of this process.

    Without torchrun's environment (no WORLD_SIZE): world size 1, no process
    group, `device` resolved as every entry point resolves it. With it: joins
    the default process group (or takes the one already initialized) over
    NCCL for a CUDA device and gloo for the CPU, with `timeout` for every
    collective, and puts the rank on `cuda:LOCAL_RANK`. `n_model` is JAX's
    model axis, which must be 1."""
    if n_model != 1:
        raise ValueError(f"n_model={n_model}: the model axis is sized 1 (no tensor "
                         "parallelism); only data parallelism is supported")
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return Mesh(rank=0, world=1, device=dev)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", rank=rank,
                                world_size=world, timeout=timeout,
                                device_id=dev if dev.type == "cuda" else None)
    if (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise RuntimeError(f"the process group is rank {dist.get_rank()} of "
                           f"{dist.get_world_size()}, the environment says {rank} of {world}")
    return Mesh(rank=rank, world=world, device=dev, backend=dist.get_backend(),
                group=dist.group.WORLD)


def local_batch_size(batch_size: int, mesh: Optional[Mesh]) -> int:
    """Rows of a global batch of `batch_size` on each rank; raises unless
    the world size divides it."""
    world = 1 if mesh is None else mesh.world
    if batch_size % world:
        raise ValueError(f"batch size {batch_size} does not divide over {world} ranks")
    return batch_size // world


def rows(n_local: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of `n_local` rows a rank."""
    rank = 0 if mesh is None else mesh.rank
    return slice(rank * n_local, (rank + 1) * n_local)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors, leading
    axis the batch); scalar entries stay whole. Raises unless the world size
    divides the batch."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) == 0:
            out[k] = v
        else:
            out[k] = v[rows(local_batch_size(v.shape[0], mesh), mesh)]
    return out


def shard_manifest(samples: Sequence, rank: int, world: int):
    """Rank `rank`'s part of a sample manifest: samples[rank::world]."""
    return samples[rank::world]


def make_global_batch(batch: Dict, mesh: Mesh) -> Dict:
    """The local batch, which is this rank's rows of the global one. On one
    process the local batch is the global batch. With several, checks that
    every rank holds the same keys and leading size (a collective), since the
    global normalizers assume equal shards."""
    if mesh.world > 1:
        mine = (sorted(batch), {k: tuple(getattr(v, "shape", ()))[:1] for k, v in batch.items()})
        every = [None] * mesh.world
        dist.all_gather_object(every, mine, group=mesh.group)
        if any(e != mine for e in every):
            raise ValueError(f"ranks hold differently shaped batches: {every}")
    return batch


def replicate_module(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Rank 0's parameters and buffers on every rank (broadcast in place),
    and, for world size > 1, the process group handed to every BatchNorm so
    that its train-mode statistics span the global batch. Returns the module."""
    if mesh.group is None:
        return module
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t, src=0, group=mesh.group)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.batch_group
    return module


def barrier(mesh: Optional[Mesh]):
    """Wait for every rank (nothing to wait for without a process group)."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def from_lead(obj, mesh: Optional[Mesh]):
    """Rank 0's `obj` on every rank (a picklable object); the other ranks
    wait here until rank 0 sends it."""
    if mesh is None or mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def all_sum_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`t` summed over the ranks, in place (itself without a process group)."""
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t
