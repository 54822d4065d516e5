"""Model operations a training image (forward and backward) times the window's images/s, over the bf16 dense peak."""
from posebench.metrics._common import mfu as read  # noqa: F401
