"""As `forward_dev_ms.train`, in the cells whose rate is `train_images_per_s.lm`."""
from posebench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ["train.augment", "train.forward"], "train.step")
