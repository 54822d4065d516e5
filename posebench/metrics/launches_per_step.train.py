"""Device kernels one training step launches, from the trace of one synchronous step."""
from posebench.metrics._common import launches_per_unit as read  # noqa: F401
