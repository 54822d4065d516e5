"""Device ms a batch of the network after its backbone: the init head, every
refine stage and the seg head (spans `posenet.init_head`, `posenet.stage`,
`posenet.seg`): the time the device ran their work, over the traced
stretch's batches (metrics/_spans.py)."""
from posebench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ["posenet.init_head", "posenet.stage", "posenet.seg"],
                         "posenet")
