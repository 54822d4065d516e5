"""Checkpointing on `torch.save`: keep-3 rolling + single best (counterpart
of checkerpose_tpu/train/checkpoint.py, same retention semantics).

A rolling window of the last `max_to_keep` step checkpoints
(`<dir>/<step>/state.pt`), resume from the max step, and a separate single
best checkpoint (`<dir>/best/<step>/state.pt`) gated on the validation
score. The payload is {model, optimizer, step, best_score}: the module's and
the optimizer's `state_dict()`. Saves are synchronous (the JAX package's are
asynchronous): `save` returns when the file is in place, written under a
temporary name and renamed, and `wait()` has nothing to wait for.

Under data parallelism (`mesh`, parallel/mesh.py) every rank holds the same
state: rank 0 writes and the others wait at a barrier until the files are in
place; every rank restores the same files after a barrier. What a rank's
caller may branch on (the latest step, the step to restore, the restored
best score) is read by rank 0 and sent to the others, so that no rank
decides from its own view of the directory (train/loop.py's rule).
`best_floor` reads the record on the rank that calls it: the loop calls it
on rank 0 and sends the floor with the gate.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import List, Optional

import torch

from checkerpose_tpu_torch.parallel.mesh import Mesh, barrier, from_lead
from checkerpose_tpu_torch.train.state import TrainState

_FILE = "state.pt"


def _payload(state: TrainState) -> dict:
    return {"model": state.module.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "best_score": float(state.best_score)}


def _steps(root: str) -> List[int]:
    """Steps with a complete checkpoint under `root`, ascending."""
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and os.path.isfile(os.path.join(root, d, _FILE)))


def _save(root: str, state: TrainState, max_to_keep: int):
    step_dir = os.path.join(root, str(int(state.step)))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, _FILE + ".tmp")
    torch.save(_payload(state), tmp)
    os.replace(tmp, os.path.join(step_dir, _FILE))
    for old in _steps(root)[:-max_to_keep]:
        shutil.rmtree(os.path.join(root, str(old)))


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 3, mesh: Optional[Mesh] = None):
        """`mesh`: every rank constructs the manager and calls each method
        (they meet at barriers); rank 0 alone writes."""
        self.dir = os.path.abspath(ckpt_dir)
        self.best_dir = os.path.join(self.dir, "best")
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        if self._writes():
            os.makedirs(self.best_dir, exist_ok=True)
        barrier(mesh)

    def _writes(self) -> bool:
        return self.mesh is None or self.mesh.lead

    def _from_lead(self, read):
        """read() on rank 0, its value on every rank (a collective under a
        mesh: every rank calls it)."""
        return from_lead(read() if self._writes() else None, self.mesh)

    def save(self, state: TrainState):
        if self._writes():
            _save(self.dir, state, self.max_to_keep)
        barrier(self.mesh)

    def save_best(self, state: TrainState, metric: str = "test_acc"):
        if self._writes():
            _save(self.best_dir, state, 1)
            # Side record of the best score, so that rolling checkpoints saved
            # before an eval (train/loop.py saves first) cannot stale it:
            # restore takes max(checkpoint's best_score, this file). It is
            # tagged with the gate metric, because a score only compares with
            # scores of the same metric. Written under a temporary name and
            # renamed.
            tmp = os.path.join(self.dir, ".best_score.json.tmp")
            with open(tmp, "w") as f:
                json.dump({"step": int(state.step), "best_score": float(state.best_score),
                           "metric": metric}, f)
            os.replace(tmp, os.path.join(self.dir, "best_score.json"))
        barrier(self.mesh)

    def _record(self) -> dict:
        try:
            with open(os.path.join(self.dir, "best_score.json")) as f:
                rec = json.load(f)
            return rec if isinstance(rec, dict) else {}
        except (OSError, ValueError):
            return {}

    def best_floor(self, metric: str) -> float:
        """Best score recorded for this gate metric; -inf when the record is
        absent or was written under another (or no) metric."""
        rec = self._record()
        try:
            return float(rec["best_score"]) if rec.get("metric") == metric else float("-inf")
        except (KeyError, TypeError, ValueError):
            return float("-inf")

    def _best_score_floor(self) -> float:
        try:
            return float(self._record()["best_score"])
        except (KeyError, TypeError, ValueError):
            return float("-inf")

    def wait(self):
        """Saves are synchronous; kept so callers read like the JAX package's."""

    def latest_step(self) -> Optional[int]:
        """The newest rolling step, as rank 0 finds it (every rank calls it)."""
        def read():
            steps = _steps(self.dir)
            return steps[-1] if steps else None
        return self._from_lead(read)

    def restore_raw(self, step: Optional[int] = None, best: bool = False) -> dict:
        """The payload as saved, on the CPU, for cross-model weight grafts."""
        barrier(self.mesh)
        root = self.best_dir if best else self.dir

        def resolve():
            """(the path to load, or None and why not) on rank 0."""
            if step is None:
                steps = _steps(root)
                if not steps:
                    return None, f"no checkpoint found in {root}"
                path = os.path.join(root, str(steps[-1]), _FILE)
            else:
                path = os.path.join(root, str(int(step)), _FILE)
            return (path, None) if os.path.isfile(path) else (None, f"no checkpoint at {path}")

        path, missing = self._from_lead(resolve)
        if missing:
            raise FileNotFoundError(missing)
        return torch.load(path, map_location="cpu", weights_only=True)

    def _restored(self, state: TrainState, raw: dict, best: bool) -> TrainState:
        best_score = float(raw["best_score"])
        if not best:
            best_score = max(best_score, self._from_lead(self._best_score_floor))
        return dataclasses.replace(state, step=int(raw["step"]), best_score=best_score)

    def restore(self, state: TrainState, step: Optional[int] = None,
                best: bool = False) -> TrainState:
        """Load module and optimizer of `state` in place (the structures
        must match) and return the state with the saved step and best score."""
        raw = self.restore_raw(step, best)
        state.module.load_state_dict(raw["model"], strict=True)
        state.optimizer.load_state_dict(raw["optimizer"])
        return self._restored(state, raw, best)

    def restore_eval(self, state: TrainState, step: Optional[int] = None,
                     best: bool = False) -> TrainState:
        """Optimizer-agnostic restore for inference and eval: loads the
        module only and keeps `state`'s optimizer, whatever optimizer the
        training run saved."""
        raw = self.restore_raw(step, best)
        state.module.load_state_dict(raw["model"], strict=True)
        return self._restored(state, raw, best)
