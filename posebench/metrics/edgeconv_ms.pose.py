"""Device ms of every EdgeConv module a batch (CUDA events at its forward's
pre- and post-hooks, summed)."""
from posebench.metrics._common import mean_ms


def read(ctx):
    return mean_ms(ctx, "edgeconv")
