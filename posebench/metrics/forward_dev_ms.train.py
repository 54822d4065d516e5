"""Device ms a training step of the augmentation and the forward with its
losses (spans `train.augment`, `train.forward`): the time the device ran
their work, over the traced stretch's steps (metrics/_spans.py)."""
from posebench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ["train.augment", "train.forward"], "train.step")
