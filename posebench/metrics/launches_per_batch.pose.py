"""Device kernels one inference batch launches, from the trace of one synchronous batch."""
from posebench.metrics._common import launches_per_unit as read  # noqa: F401
