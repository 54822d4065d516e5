"""Percent of the traced stretch of the open loop in which no device
operation ran while the host was inside the solver (span `solver`)."""
from posebench.metrics._spans import idle_share_inside


def read(ctx):
    return idle_share_inside(ctx, "solver")
