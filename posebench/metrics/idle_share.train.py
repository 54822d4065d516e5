"""Share of the traced stretch of training steps in which no device operation ran."""
from posebench.metrics._common import idle_share as read  # noqa: F401
