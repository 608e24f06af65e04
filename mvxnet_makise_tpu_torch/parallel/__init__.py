"""Data and model parallelism over ``torch.distributed`` (port of
``mvxnet_makise_tpu/parallel``)."""

from mvxnet_makise_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_sharding,
    replicated,
    shard_batch,
    shard_params,
)
