"""Tensor operations and the port's CUDA kernels (column_merge: K1,
gather: K2)."""

from mvxnet_makise_tpu_torch.ops.voxelize import (  # noqa: F401
    VoxelGrid,
    crop_to_range_mask,
    frustum_mask,
    voxelize,
)
from mvxnet_makise_tpu_torch.ops.assign import (  # noqa: F401
    AnchorTargets,
    assign_anchor_targets,
    create_anchors,
)
from mvxnet_makise_tpu_torch.ops.scatter import (  # noqa: F401
    scatter_voxels_to_grid,
)
from mvxnet_makise_tpu_torch.ops.nms import (  # noqa: F401
    rotated_nms_bev,
    rotated_nms_bev_batch,
)
