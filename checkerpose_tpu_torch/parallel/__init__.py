from checkerpose_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_global_batch, make_mesh, replicate_module, shard_batch, shard_manifest,
)
