"""The training loop shared by pretraining and training (counterpart of
checkerpose_tpu/train/loop.py, same cadence and gate logic).

An endless step loop over the loader, loss logging every `log_freq` steps,
a rolling keep-3 checkpoint every `save_freq` steps and, every `test_freq`
steps, a validation sweep that gates the best checkpoint.

Not carried over from the JAX package: the device mesh with its batch
sharding and state replication (data parallelism is queued in ROADMAP.md),
and the periodic deletion of input buffers under `sync_freq`, which worked
around the runtime of that package's remote TPU client. PyTorch's caching
allocator frees a batch when its last reference goes, so the loop only
bounds how far the host may run ahead of the card.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import torch

from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.state import TrainState
from checkerpose_tpu_torch.utils.logging import MetricWriter


def run_training(*, state: TrainState, step_fns, loader: Iterable, total_iteration: int,
                 eval_fn: Callable[[torch.nn.Module], Dict], ckpt: CheckpointManager,
                 writer: MetricWriter, log_freq: int = 100, test_freq: int = 1000,
                 save_freq: Optional[int] = None,
                 get_stage: Optional[Callable[[int], int]] = None,
                 extra_batch: Optional[Callable[[Dict], Dict]] = None,
                 seed: int = 0, sync_freq: int = 8) -> TrainState:
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
      seed: of the generator every step draws from.
      sync_freq: read one metric on the host every N steps, which bounds the
        work queued on the card at N batches.
    """
    module = state.module
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
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        stage = get_stage(state.step) if get_stage else None
        metrics = step_fns[stage](state, batch, generator)
        step_no = state.step
        if step_no % sync_freq == 0:
            float(metrics["loss"])

        if step_no % log_freq == 0:
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
            module.eval()
            try:
                ev = eval_fn(module)
            finally:
                module.train()
            writer.add_scalar("TESTDATA_ACC/ACC_test", ev["test_acc"], step_no)
            gate = float(ev.get("gate_score", ev["test_acc"]))
            gate_metric = str(ev.get("gate_metric", "test_acc"))
            if best is None:
                best = ckpt.best_floor(gate_metric)
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
