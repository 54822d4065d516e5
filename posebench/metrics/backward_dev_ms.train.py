"""Device ms a training step of the backward (span `train.backward`: the
gradients zeroed, then accumulated): the time the device ran its work,
without the device's waits for the host inside it, over the traced stretch's
steps (metrics/_spans.py)."""
from posebench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ["train.backward"], "train.step")
