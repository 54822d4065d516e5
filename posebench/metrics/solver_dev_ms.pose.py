"""Device ms a batch of the pose solver (span `solver`, the whole of
`ransac_pnp`): the time the device ran its work, without the device's waits
for the host inside it, over the traced stretch's batches
(metrics/_spans.py)."""
from posebench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ["solver"], "posenet")
