"""The point-major MVX-Net detector in PyTorch modules."""

from mvxnet_makise_tpu_torch.models.blocks import (  # noqa: F401
    ConvReluNorm,
    DeconvReluNorm,
    DenseReluNorm,
    masked_standardize,
    standardize,
)
from mvxnet_makise_tpu_torch.models.voxelnet import (  # noqa: F401
    RPN,
    MiddleConvLayers,
)
from mvxnet_makise_tpu_torch.models.resnet_fpn import (  # noqa: F401
    ResNet50FPN,
    load_torchvision_fpn_weights,
)
from mvxnet_makise_tpu_torch.models.image_head import (  # noqa: F401
    PointImageFusion,
    PointImageHead,
    detection_transform,
)
from mvxnet_makise_tpu_torch.models.mvxnet import (  # noqa: F401
    MVXNetPM,
    MVXNetVoxelFusion,
)
from mvxnet_makise_tpu_torch.models.voxelnet_pm import (  # noqa: F401
    VoxelNetBranchPM,
)
