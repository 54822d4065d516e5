"""Metric logging: JSONL always, TensorBoard when available (the port's own
copy of checkerpose_tpu/utils/logging.py::MetricWriter; same scalar names and
file format)."""
from __future__ import annotations

import json
import os
import time


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:                  # the tensorboard package is optional
                pass
            else:
                self.tb = SummaryWriter(log_dir)

    def add_scalar(self, name: str, value: float, step: int):
        self.add_scalars({name: value}, step)

    def add_scalars(self, scalars: dict, step: int):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
