"""Diagnostic tools of the port, each run as `python -m checkerpose_tpu_torch.tools.<name>`."""
