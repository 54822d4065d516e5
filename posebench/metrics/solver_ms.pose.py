"""Host ms of the pose solver a batch, the device synchronised at both ends
(in the evaluation cell the solver and the metrics, as the harness spans them)."""
from posebench.metrics._common import mean_ms


def read(ctx):
    return mean_ms(ctx, "solver")
