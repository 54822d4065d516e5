"""As `peak_mem_gib.train`, in the cells whose rate is `train_images_per_s.lm`."""
from posebench.metrics._common import peak_gib as read  # noqa: F401
