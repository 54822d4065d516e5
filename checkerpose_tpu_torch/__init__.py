"""PyTorch/CUDA port of checkerpose_tpu for NVIDIA Hopper (H100).

The JAX package `checkerpose_tpu` is the reference; every module here mirrors
its counterpart's path and class names and is held against it by the parity
tests in `tests/test_torch_*.py`. This package imports torch and never jax.

Entry points (`serving.ServingPipeline`, `models.posenet.make_posenet`,
`solver.ransac.solve_poses_batched`, `train.state.create_init_state`,
`train.state.create_pose_state`) take `device="cuda"` by default and raise
when no card is present; the CPU is used only when the caller passes
`device="cpu"`.
"""
