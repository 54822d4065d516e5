"""Host ms a batch inside the network, the decode and the solver (spans
`posenet`, `decode`, `solver`) less the host's waits on the device there
(synchronisations, and launches and copies past their usual cost while the
device runs): the time the host takes to queue a batch's forward, decode and
solve, over the traced stretch's batches (metrics/_spans.py)."""
from posebench.metrics._spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, ["posenet", "decode", "solver"], "posenet")
