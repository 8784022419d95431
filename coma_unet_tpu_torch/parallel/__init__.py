"""Data and spatial parallelism of the port (counterpart of
`coma_unet_tpu/parallel/`): a `torch.distributed` group of N ranks in place
of the JAX mesh, each rank on its rows of the batch (`mesh.py`) or on its
depth slab of the volume (`spatial.py`)."""

from coma_unet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    destroy_mesh,
    make_mesh,
    make_sharded_eval_step,
    make_sharded_train_step,
    replicate_state,
    shard_batch,
)
from coma_unet_tpu_torch.parallel.spatial import (  # noqa: F401
    make_spatial_infer_fn,
    plan_slabs,
)
