"""Peak device memory of the inference run (GiB)."""
from posebench.metrics._common import peak_gib as read  # noqa: F401
