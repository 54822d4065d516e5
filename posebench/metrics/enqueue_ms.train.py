"""Host ms a training step inside the step (span `train.step`) less the
host's waits on the device there (synchronisations, and launches and copies
past their usual cost while the device runs), over the traced stretch's
steps (metrics/_spans.py)."""
from posebench.metrics._spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, ["train.step"], "train.step")
