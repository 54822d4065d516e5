"""As `enqueue_ms.train`, in the cells whose rate is `train_images_per_s.lm`."""
from posebench.metrics._spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, ["train.step"], "train.step")
