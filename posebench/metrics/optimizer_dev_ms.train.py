"""Device ms a training step of the optimizer (span `train.optimizer`: zero
fill of unreached gradients, any all-reduce, Adam's step): the time the
device ran its work, over the traced stretch's steps (metrics/_spans.py)."""
from posebench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ["train.optimizer"], "train.step")
