"""Model operations a crop times the window's crops/s, over the bf16 dense peak."""
from posebench.metrics._common import mfu as read  # noqa: F401
