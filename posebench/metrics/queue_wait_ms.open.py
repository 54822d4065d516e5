"""95th percentile of the requests' wait in the harness's batcher: from the
due time to the start of the call that serves the request."""
from posebench.loops.common import percentile


def read(ctx):
    waits = ctx.spans.get("queue_wait")
    return 1e3 * percentile(waits, 95) if waits else None
