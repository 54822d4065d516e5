"""Model operations a crop times the crops/s served in the window, over the bf16 dense peak."""
from posebench.metrics._common import mfu as read  # noqa: F401
