"""The training loop shared by pretraining and training (counterpart of
checkerpose_tpu/train/loop.py, same cadence and gate logic).

An endless step loop over the loader, loss logging every `log_freq` steps,
a rolling keep-3 checkpoint every `save_freq` steps and, every `test_freq`
steps, a validation sweep that gates the best checkpoint.

Data parallelism (`mesh`, parallel/mesh.py; the JAX loop's mesh): every
rank runs this loop over its own loader, which yields its rows of each
global batch. The module is replicated from rank 0, the steps sum the
gradients over the ranks (train/steps.py), rank 0 alone writes checkpoints,
metrics and log lines, and rank 0 alone runs `eval_fn` (as JAX's harness
evaluates unsharded) while the others wait for its gate score. The loop
starts from rank 0's module and step. Not carried over: the periodic
deletion of input buffers under `sync_freq`, which worked around the runtime
of the JAX package's remote TPU client. PyTorch's caching allocator frees a
batch when its last reference goes, so the loop only bounds how far the host
may run ahead of the card.

The rule that keeps the ranks in step: a branch that contains a collective
(a step's all-reduces, `ckpt.save_best`'s barrier, `from_lead`) is decided
only from values that every rank received from the same collective, never
from a rank's own state (its files, its clock, its eval). So rank 0 resolves
the gate's floor from best_score.json and sends it with the gate, and a
failed eval on rank 0 is sent too, so that every rank raises rather than
waits in a collective that rank 0 never joins.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import torch

from checkerpose_tpu_torch.parallel.mesh import Mesh, from_lead, make_global_batch, replicate_module
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.state import TrainState
from checkerpose_tpu_torch.utils.logging import MetricWriter


def run_training(*, state: TrainState, step_fns, loader: Iterable, total_iteration: int,
                 eval_fn: Callable[[torch.nn.Module], Dict], ckpt: CheckpointManager,
                 writer: MetricWriter, log_freq: int = 100, test_freq: int = 1000,
                 save_freq: Optional[int] = None,
                 get_stage: Optional[Callable[[int], int]] = None,
                 extra_batch: Optional[Callable[[Dict], Dict]] = None,
                 mesh: Optional[Mesh] = None, seed: int = 0,
                 sync_freq: int = 8) -> TrainState:
    """Args:
      state: module (on its device, in train mode) + optimizer; trained in
        place and returned with the final step and best score.
      step_fns: dict stage -> step (or {None: step} when no curriculum);
        each is `step(state, batch, generator) -> metrics` (train/steps.py).
      loader: yields dicts of numpy arrays or tensors; they are moved to the
        module's device here.
      eval_fn: module (in eval mode) -> metrics dict. The best checkpoint is
        gated on "gate_score" when present (with its metric named by
        "gate_metric"), else on "test_acc". The gate's memory lives in the
        metric-tagged best_score.json side record
        (CheckpointManager.best_floor), not in the restored state's
        best_score, so a record written under another gate definition is
        ignored rather than trusted.
      save_freq: rolling-checkpoint cadence (defaults to test_freq). The
        rolling save happens before any eval at the same step, so that a
        failure inside the eval sweep cannot lose the steps before it;
        the best score's freshness across that order is kept by the
        best_score.json side record.
      get_stage: step -> curriculum stage.
      extra_batch: hook to add derived fields (e.g. broadcast p3d_normed).
      mesh: the data-parallel mesh, or None for one process; `ckpt` must be
        built with the same mesh, and `writer` is used on rank 0 only (None
        on the others).
      seed: of the generator every step draws from (alike on every rank).
      sync_freq: read one metric on the host every N steps, which bounds the
        work queued on the card at N batches.
    """
    module = state.module
    lead = mesh is None or mesh.lead
    if mesh is not None:
        replicate_module(module, mesh)
        # and rank 0's step, which every branch below counts from: a CLI may
        # have reset it from files a rank reads itself (a backbone graft)
        state.step = from_lead(state.step, mesh)
        state.mesh = mesh
    device = next(module.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    # the gate's memory is resolved at the first eval from the metric-tagged
    # side record: the restored best_score may stem from another gate metric
    best = None
    t_last = time.time()
    data_iter = iter(loader)
    loader_wait = 0.0            # time blocked on the input pipeline this log window

    def floor_or_best():
        return best if best is not None else float("-inf")

    module.train()
    while state.step < total_iteration:
        t_fetch = time.time()
        batch = next(data_iter)
        loader_wait += time.time() - t_fetch
        batch.pop("n_real", None)
        if extra_batch is not None:
            batch = extra_batch(batch)
        if mesh is not None:
            batch = make_global_batch(batch, mesh)
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        stage = get_stage(state.step) if get_stage else None
        metrics = step_fns[stage](state, batch, generator)
        step_no = state.step
        if step_no % sync_freq == 0:
            float(metrics["loss"])

        if step_no % log_freq == 0 and lead:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.time() - t_last) / log_freq
            t_last = time.time()
            m["step_time_s"] = dt
            m["loader_wait_s"] = loader_wait / log_freq
            loader_wait = 0.0
            eta_h = dt * (total_iteration - step_no) / 3600.0
            writer.add_scalars({f"TRAIN/{k}": v for k, v in m.items()}, step_no)
            print(f"step {step_no}/{total_iteration} "
                  + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                  + f" eta={eta_h:.2f}h", flush=True)

        at_end = step_no == total_iteration
        if step_no % (save_freq or test_freq) == 0 or at_end:
            state.best_score = floor_or_best()
            ckpt.save(state)                 # before the eval (see save_freq)
        if step_no % test_freq == 0 or at_end:
            gate = gate_metric = floor = failed = None
            if lead:
                module.eval()
                try:
                    ev = eval_fn(module)
                except Exception as e:
                    if mesh is None or mesh.group is None:
                        raise
                    failed = e
                finally:
                    module.train()
                if failed is None:
                    writer.add_scalar("TESTDATA_ACC/ACC_test", ev["test_acc"], step_no)
                    gate = float(ev.get("gate_score", ev["test_acc"]))
                    gate_metric = str(ev.get("gate_metric", "test_acc"))
                    if best is None:
                        floor = ckpt.best_floor(gate_metric)
            # the gate, its floor and a failure travel together (the module docstring)
            gate, gate_metric, floor, why = from_lead(
                (gate, gate_metric, floor, None if failed is None else repr(failed)), mesh)
            if why is not None:
                if failed is not None:
                    raise failed
                raise RuntimeError(f"rank 0's eval at step {step_no} failed: {why}")
            if best is None:
                best = floor
            if lead:
                print(f"eval @ {step_no}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in ev.items() if isinstance(v, (int, float)))
                    + f" gate[{gate_metric}]={gate:.4f} (best {best:.4f})", flush=True)
            if gate > best:
                best = gate
                state.best_score = best
                ckpt.save_best(state, metric=gate_metric)

    ckpt.wait()
    state.best_score = floor_or_best()
    return state
