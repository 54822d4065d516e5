"""Device ms a batch of the backbone (span `posenet.backbone`): the time the
device ran its work, over the traced stretch's batches (metrics/_spans.py)."""
from posebench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ["posenet.backbone"], "posenet")
