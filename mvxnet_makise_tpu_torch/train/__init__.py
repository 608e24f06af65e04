"""Training: batch layout, loss, optimizer, step, checkpoints, loop."""

from mvxnet_makise_tpu_torch.train.loss import (  # noqa: F401
    smooth_l1,
    voxel_loss,
)
