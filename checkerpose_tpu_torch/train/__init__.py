"""Training: state, steps, checkpoints and the loop (counterpart of
checkerpose_tpu/train)."""
