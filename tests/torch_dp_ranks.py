"""Rank processes of the port's data-parallel tests (gloo on the CPU).

`run(target, world, workdir, *args)` starts `world` spawned processes with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and a free
MASTER_PORT) and one intra-op thread each, and calls `target(rank, world,
workdir, *args)`, a function of this module, in every one. A rank saves what
its target returns to `workdir/rank<r>.pt` and its printed lines to
`workdir/rank<r>.log`; `run` waits at most `timeout` seconds for them all,
kills any rank still alive, and returns the values by rank, or raises with the
tracebacks of the ranks that failed. Each rank's process group has a 60 s
timeout, so a collective that one rank never joins fails rather than hangs.

The module imports neither jax nor checkerpose_tpu, so a rank starts in
seconds; the tests compute their one-process references with the same
functions (`LOSS_CASES`, `pose_state`, `pose_step`)."""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import socket
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from checkerpose_tpu_torch import losses
from checkerpose_tpu_torch.models.layers import BatchNorm
from checkerpose_tpu_torch.models.posenet import PoseNet
from checkerpose_tpu_torch.parallel.mesh import (Mesh, all_sum_, make_global_batch, make_mesh,
                                                 replicate_module, shard_batch)
from checkerpose_tpu_torch.train import steps
from checkerpose_tpu_torch.train.state import TrainState

GROUP_TIMEOUT = datetime.timedelta(seconds=60)

# hrnet_w18_small, 16 keypoints, K=5, one graph module, f32
POSE_CFG = dict(npoint=16, res_log2=6, backbone_name="hrnet_w18_small", num_graph_module=1,
                init_num_graph_module=1, local_k=2, dtype=torch.float32)
POSE_STAGE = 1
# augmentation and teacher forcing on, as a training config has them
AUG_OPTS = dict(use_pepper_salt=True, use_motion_blur=True, color_aug_prob=0.8,
                teacher_force_prob=0.5)
PLAIN_OPTS = dict(use_pepper_salt=False, use_motion_blur=False, color_aug_prob=0.0)
STEP_SEED = 7
# SGD's rate in the step held to tests/test_sharding.py's bars (per leaf abs <
# 5e-4 or rel < 1e-3 after the step). Near-ties in EdgeConv's max over K turn
# the ranks' other summation order into gradients ~1% apart (as f32 against
# f64 in one process), which at 1e-2 stay 6x inside the bar, while DDP's
# per-rank normalizers move 11-22 leaves beyond it. (JAX's test steps at 1e-3,
# where the per-rank normalizers would pass as well.)
DP_LR = 1e-2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, target: str, workdir: str, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    out = Path(workdir)
    try:
        with open(out / f"rank{rank}.log", "w") as log, contextlib.redirect_stdout(log):
            result = globals()[target](rank, world, out, *args)
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(target: str, world: int, workdir, *args, timeout: float = 60.0):
    """The values `target` returned on each rank (see the module docstring)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, target, str(workdir), args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errors = {r: (workdir / f"rank{r}.err").read_text()
              for r in range(world) if (workdir / f"rank{r}.err").exists()}
    if alive or errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"{target}: ranks {alive} still running after {timeout} s, exit "
                           f"codes {[p.exitcode for p in procs]}\n" + "\n".join(
                               f"--- rank {r} ---\n{e}" for r, e in errors.items()))
    return [torch.load(workdir / f"rank{r}.pt", weights_only=True) for r in range(world)]


# --- what the tests hold a W-rank run against --------------------------------------------

def _rows(t, mesh):
    return t if mesh is None else shard_batch({"t": t}, mesh)["t"]


def _leaf(t, mesh):
    return _rows(t, mesh).detach().clone().requires_grad_(True)


def _masked_bce(inp, g):
    return losses.masked_code_loss(inp["logits"], inp["gt"], inp["mask"], "BCE", g)


def _masked_l1(inp, g):
    return losses.masked_code_loss(inp["logits"], inp["gt"], inp["mask"], "L1", g)


def _masked_ce(inp, g):
    return losses.masked_code_loss(inp["logits"], inp["ce_gt"], inp["mask"], "CE", g)


def _per_bit(inp, g):
    return losses.per_bit_masked_code_loss(inp["logits"], inp["gt"], inp["mask"],
                                           inp["bit_masks"], (1.0, 2.0, 0.5, 1.0), "BCE", g)


def _unmasked(inp, g):
    return losses.unmasked_code_loss(inp["logits"], inp["gt"], "BCE", g)


def _seg(inp, g):
    return losses.mask_loss_interpolate(inp["seg"], inp["seg_gt"], g)


def _cell_ce(inp, g):
    return steps._aux_heatmap_loss(inp["resp"], inp["mask"], inp["x_id"], inp["y_id"], 6, g)


def _coord(inp, g):
    return steps._coord_reg_loss(inp["logits"], inp["logits2"], inp["x_rel"], inp["y_rel"],
                                 inp["mask"], 4, 6, g)


def _nocs(inp, g):
    total, _ = steps.nocs_loss(lambda imgs: inp["nocs_out"], None, inp, inp["depth"], 80.0,
                               0.5, g)
    return total


# name -> (loss(inputs, group), the inputs it differentiates)
LOSS_CASES = {"masked_bce": (_masked_bce, ("logits",)), "masked_l1": (_masked_l1, ("logits",)),
              "masked_ce": (_masked_ce, ("logits",)), "per_bit": (_per_bit, ("logits",)),
              "unmasked": (_unmasked, ("logits",)), "seg": (_seg, ("seg",)),
              "aux_cell_ce": (_cell_ce, ("resp",)), "coord": (_coord, ("logits", "logits2")),
              "nocs": (_nocs, ("nocs_out",))}


def loss_case(name, inputs, mesh=None):
    """(the loss over every rank, {input: this rank's rows of its gradient})
    of one case on `mesh` (None: one process on the whole batch)."""
    fn, wrt = LOSS_CASES[name]
    inp = {k: (_leaf(v, mesh) if k in wrt else _rows(v, mesh)) for k, v in inputs.items()}
    part = fn(inp, None if mesh is None else mesh.batch_group)
    part.backward()
    return all_sum_(part.detach().clone(), mesh), {k: inp[k].grad for k in wrt}


def batchnorm_case(inputs, mesh=None):
    """A train-mode BatchNorm over (B, C, H, W) with a weighted global-mean
    loss: its output rows, input-gradient rows, parameter gradients (summed
    over the ranks) and new running statistics."""
    bn = BatchNorm(inputs["x"].shape[1])
    with torch.no_grad():
        bn.weight.copy_(inputs["weight"])
        bn.bias.copy_(inputs["bias"])
    if mesh is not None:
        bn.group = mesh.batch_group
    x = _leaf(inputs["x"], mesh)
    y = bn(x)
    losses.global_mean(y * _rows(inputs["r"], mesh), bn.group).backward()
    return {"y": y.detach(), "x_grad": x.grad, "w_grad": all_sum_(bn.weight.grad, mesh),
            "b_grad": all_sum_(bn.bias.grad, mesh), "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def linear_case(inputs, mesh=None):
    """The gradient of a Linear's mean squared error, summed over the ranks."""
    lin = torch.nn.Linear(4, 4)
    with torch.no_grad():
        lin.weight.copy_(inputs["w"])
        lin.bias.copy_(inputs["b"])
    loss = losses.global_mean((lin(_rows(inputs["x"], mesh)) - _rows(inputs["y"], mesh)) ** 2,
                              None if mesh is None else mesh.batch_group)
    loss.backward()
    return {"weight": all_sum_(lin.weight.grad, mesh), "bias": all_sum_(lin.bias.grad, mesh)}


def pose_state(pose, lr: float, mesh=None) -> TrainState:
    """A PoseNet (POSE_CFG) from `pose["state_dict"]` in train mode with SGD
    at `lr`; replicated over `mesh`."""
    net = PoseNet(**POSE_CFG)
    net.load_state_dict(pose["state_dict"], strict=True)
    st = TrainState(module=net.train(), optimizer=torch.optim.SGD(net.parameters(), lr=lr))
    if mesh is not None:
        replicate_module(net, mesh)
        st.mesh = mesh
    return st


def pose_step(pose, state: TrainState, opts, mesh=None):
    """One step (POSE_STAGE, generator seeded STEP_SEED) on this rank's rows
    of `pose["batch"]`: its metrics."""
    step = steps.make_train_step(state.module, pose["knn"], POSE_STAGE, **opts)
    batch = pose["batch"] if mesh is None else shard_batch(pose["batch"], mesh)
    return step(state, batch, torch.Generator().manual_seed(STEP_SEED))


def state_tensors(state: TrainState):
    return {k: v.detach().clone() for k, v in state.module.state_dict().items()}


def _spread(state: TrainState, mesh: Mesh) -> float:
    """The largest difference of any parameter or buffer from rank 0's."""
    flat = torch.cat([t.detach().reshape(-1).double()
                      for t in state.module.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    return float((flat - ref).abs().max())


# --- the rank targets --------------------------------------------------------------------

def library_checks(rank, world, workdir):
    """Every library check of tests/test_torch_parallel.py on a 4-rank world
    and on its 2-rank subgroup {0, 1}."""
    inputs = torch.load(workdir / "inputs.pt", weights_only=True)
    mesh4 = make_mesh("cpu", timeout=GROUP_TIMEOUT)
    g2 = dist.new_group([0, 1], timeout=GROUP_TIMEOUT)
    mesh2 = Mesh(rank, 2, mesh4.device, "gloo", g2) if rank < 2 else None
    out = {"mesh": {"rank": mesh4.rank, "world": mesh4.world, "backend": mesh4.backend,
                    "device": str(mesh4.device), "group": mesh4.group is dist.group.WORLD}}
    toy = {"x": torch.arange(16.0).view(8, 2), "s": torch.tensor(3.0)}
    out["shard"] = shard_batch(toy, mesh4)
    out["global_batch_same"] = make_global_batch(toy, mesh4) is toy
    try:
        make_global_batch({"x": toy["x"][:2 if rank == 3 else 1]}, mesh4)
        out["global_batch_mismatch"] = "accepted"
    except ValueError:
        out["global_batch_mismatch"] = "refused"

    meshes = {4: mesh4, 2: mesh2}
    for w, mesh in meshes.items():
        if mesh is None:
            continue
        out[f"linear{w}"] = linear_case(inputs["linear"], mesh)
        out[f"bn{w}"] = batchnorm_case(inputs["bn"], mesh)
    if mesh2 is not None:
        out["losses2"] = {name: loss_case(name, inputs["losses"], mesh2) for name in LOSS_CASES}

    pose = inputs["pose"]
    for w, mesh in meshes.items():
        if mesh is None:
            continue
        st = pose_state(pose, DP_LR, mesh)
        metrics = pose_step(pose, st, AUG_OPTS, mesh)
        out[f"pose{w}"] = {"metrics": metrics, "spread": _spread(st, mesh),
                           "state": state_tensors(st) if rank == 0 else None}
    # per-rank normalizers, DDP's arithmetic: each rank's own mean loss, the
    # gradients averaged (SGD at 1 / W of the rate on their sum)
    st = pose_state(pose, DP_LR / world, mesh4)
    with _local_normalizers():
        metrics = pose_step(pose, st, AUG_OPTS, mesh4)
    out["pose4_per_rank"] = {"loss": float(all_sum_(metrics["loss"].clone(), mesh4)) / world,
                             "state": state_tensors(st) if rank == 0 else None}
    if mesh2 is not None:                                   # against JAX's step
        st = pose_state(pose, 1.0, mesh2)
        metrics = pose_step(pose, st, PLAIN_OPTS, mesh2)
        out["jax2"] = {"metrics": metrics, "state": state_tensors(st) if rank == 0 else None}

    out["solver"] = _solver_rows(inputs["solver"], mesh4)
    if mesh2 is not None:
        out["run_training"] = _run_training(mesh2, workdir)
    return out


@contextlib.contextmanager
def _local_normalizers():
    keep = steps._batch_group
    steps._batch_group = lambda state: None
    try:
        yield
    finally:
        steps._batch_group = keep


def _solver_rows(inp, mesh):
    """This rank's poses, its hypotheses drawn for the whole batch from a
    generator seeded alike on every rank."""
    from checkerpose_tpu_torch.solver.ransac import sample_hypotheses, solve_poses_batched
    hyp = sample_hypotheses(inp["valid"], inp["num_hyp"], 6, torch.Generator().manual_seed(0))
    mine = shard_batch({k: inp[k] for k in ("p2d", "valid")} | {"hyp": hyp}, mesh)
    sol = solve_poses_batched(inp["p3d"], mine["p2d"], mine["valid"], inp["K"],
                              hyp_idx=mine["hyp"], device="cpu", num_hyp=inp["num_hyp"])
    return {"R": sol["R"], "t": sol["t"]}


class _Tiny(torch.nn.Module):
    """A Linear and a BatchNorm: what run_training needs of a module."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 4)
        self.bn = BatchNorm(4)

    def forward(self, x):
        return self.bn(self.lin(x))


def _tiny_step(state: TrainState, batch, generator):
    """A step in train/steps.py's form: the global mean squared error, the
    gradients summed over the ranks, the metrics global."""
    loss = losses.global_mean((state.module(batch["x"]) - batch["y"]) ** 2,
                              steps._batch_group(state))
    steps._update(state, loss)
    return steps._reported({"loss": loss}, state)


def _tiny_state():
    torch.manual_seed(0)
    net = _Tiny().train()
    return TrainState(module=net, optimizer=torch.optim.SGD(net.parameters(), lr=0.1))


def _run_training(mesh, workdir):
    """run_training over 3 steps with rank 0's writer and checkpoints, then
    a fresh state restored on every rank and run on to step 4."""
    from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
    from checkerpose_tpu_torch.train.loop import run_training
    from checkerpose_tpu_torch.utils.logging import MetricWriter
    g = torch.Generator().manual_seed(1)
    local = shard_batch({"x": torch.randn(4, 3, generator=g),
                         "y": torch.randn(4, 4, generator=g)}, mesh)
    evals = []

    def eval_fn(module):
        evals.append(len(evals))
        return {"test_acc": float(len(evals))}

    def go(state, total):
        writer = MetricWriter(str(workdir / "tb"), use_tensorboard=False) if mesh.lead else None
        ckpt = CheckpointManager(str(workdir / "ckpt"), mesh=mesh)
        state = run_training(state=state, step_fns={None: _tiny_step},
                             loader=iter(lambda: dict(local), None), total_iteration=total,
                             eval_fn=eval_fn, ckpt=ckpt, writer=writer, log_freq=1,
                             test_freq=2, mesh=mesh)
        if writer is not None:
            writer.close()
        return state

    st = go(_tiny_state(), 3)
    first = {"step": st.step, "spread": _spread(st, mesh), "state": state_tensors(st)}
    restored = CheckpointManager(str(workdir / "ckpt"), mesh=mesh).restore(_tiny_state())
    restored_step = restored.step
    same = all(torch.equal(v, first["state"][k])
               for k, v in restored.module.state_dict().items())
    st = go(restored, 4)
    return {"first_step": first["step"], "first_spread": first["spread"],
            "restored_step": restored_step, "restored_equal": same, "resumed_step": st.step,
            "resumed_spread": _spread(st, mesh), "evals": len(evals)}


def cli_pretrain(rank, world, workdir, cfg):
    """The pretrain CLI's main under torchrun's environment (its metric
    writer without TensorBoard, whose import takes ~20 s here)."""
    from checkerpose_tpu_torch.cli import pretrain
    sys.modules["torch.utils.tensorboard"] = None
    st = pretrain.main(cfg)
    return {"step": st.step, "world": st.mesh.world, "backend": st.mesh.backend,
            "spread": _spread(st, st.mesh), "batch_rows": _first_batch_rows(cfg, st.mesh)}


def _first_batch_rows(cfg, mesh):
    from checkerpose_tpu_torch.cli import common
    from checkerpose_tpu_torch.data.fps import load_keypoints_normed
    xyz = load_keypoints_normed(cfg["bop_path"], cfg["dataset_name"], cfg["obj_id"],
                                2 ** int(cfg["num_p3d_log2"]))[0]
    loader, _ = common.build_train_loaders(cfg, xyz, mesh=mesh)
    return int(len(next(iter(loader))["image"]))


if __name__ == "__main__":                       # pragma: no cover
    sys.exit("a helper module of the tests: import it")
