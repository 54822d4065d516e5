"""As `launches_per_step.train`, in the cells whose rate is `train_images_per_s.lm`."""
from posebench.metrics._common import launches_per_unit as read  # noqa: F401
