"""As `mfu.train`, in the cells whose rate is `train_images_per_s.lm`."""
from posebench.metrics._common import mfu as read  # noqa: F401
