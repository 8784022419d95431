"""Data parallelism of the port (counterpart of `coma_unet_tpu/parallel/`):
a `torch.distributed` group of N ranks in place of the JAX mesh's `data`
axis."""

from coma_unet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    destroy_mesh,
    make_mesh,
    make_sharded_eval_step,
    make_sharded_train_step,
    replicate_state,
    shard_batch,
)
