"""Host ms of the network forward and decode a batch, the device
synchronised at both ends."""
from posebench.metrics._common import mean_ms


def read(ctx):
    return mean_ms(ctx, "forward")
