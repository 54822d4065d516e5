"""As `idle_share.train`, in the cells whose rate is `train_images_per_s.lm`."""
from posebench.metrics._common import idle_share as read  # noqa: F401
