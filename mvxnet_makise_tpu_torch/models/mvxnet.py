"""MVXNetPM: the fully point-major MVX-Net PointFusion detector.

Port of ``MVXNetPM`` (``mvxnet_makise_tpu/models/mvxnet.py``): per-point
image features (``head``) concatenated with the 7 LiDAR channels feed the
point-major LiDAR branch (``backbone``); the empty sample slots of each
voxel enter with the zero LiDAR row and the image branch's empty-slot
feature (``z0``).  :func:`build_model` also builds the LiDAR-only
detector, ``VoxelNetBranchPM`` on the 7 LiDAR channels alone.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.device import DeviceLike, resolve_device
from mvxnet_makise_tpu_torch.models.image_head import PointImageHead
from mvxnet_makise_tpu_torch.models.voxelnet import REFERENCE_RPN_TRUNK
from mvxnet_makise_tpu_torch.models.voxelnet_pm import (
    VoxelNetBranchPM,
    point_lidar_features,
)


class MVXNetPM(nn.Module):
    def __init__(self, grid_shape=(352, 400, 10),
                 image_size: Tuple[int, int] = (370, 1224),
                 anchors_per_loc: int = 2, box_dim: int = 7,
                 eps: float = 1e-6, swapped_bilerp: bool = False,
                 samples_per_voxel: int = 35,
                 image_min_side: float = 800.0,
                 rpn_trunk: Tuple = REFERENCE_RPN_TRUNK,
                 cml_mode: str = "column", scatter_backend: str = "auto",
                 remat: bool = False):
        super().__init__()
        self.samples_per_voxel = samples_per_voxel
        self.head = PointImageHead(image_size, eps, swapped_bilerp,
                                   image_min_side)
        self.backbone = VoxelNetBranchPM(
            7 + 16, grid_shape, anchors_per_loc, box_dim, eps,
            samples_per_voxel, rpn_trunk, cml_mode, scatter_backend, remat)

    def fused_inputs(self, sorted_points, sorted_kept, sorted_seg, counts,
                     vmask, images):
        """Per-point 23-channel inputs of the LiDAR branch and the
        empty-slot row per voxel: (x (B, P, 23), z0 (B, V, 23))."""
        B, V = counts.shape
        n_virtual = (vmask.sum(dim=1) * self.samples_per_voxel
                     - sorted_kept.sum(dim=1))
        imfeat, z16 = self.head(images, sorted_points[..., 4:6],
                                sorted_kept, n_virtual)
        pf7 = point_lidar_features(sorted_points, sorted_seg, sorted_kept,
                                   counts, self.samples_per_voxel)
        x = torch.cat([pf7.to(imfeat.dtype), imfeat], dim=-1)
        z0 = torch.cat([imfeat.new_zeros((B, V, 7)),
                        z16[:, None, :].expand(B, V, z16.shape[-1])],
                       dim=-1)
        return x, z0

    def forward(self, sorted_points: torch.Tensor,
                sorted_kept: torch.Tensor, sorted_seg: torch.Tensor,
                counts: torch.Tensor, coords: torch.Tensor,
                vmask: torch.Tensor, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """sorted_points: (B, P, 6) voxel-sorted [x y z refl row col];
        sorted_kept/seg: (B, P); counts: (B, V); coords: (B, V, 3);
        vmask: (B, V); images: (B, H, W, 3).  Returns (score (B, H/2,
        W/2, A), reg (B, H/2, W/2, A*7))."""
        x, z0 = self.fused_inputs(sorted_points, sorted_kept, sorted_seg,
                                  counts, vmask, images)
        return self.backbone(x, sorted_kept, sorted_seg, counts, coords,
                             vmask, z0)


# the norms' eps of the models JAX's train/loop.build_model_and_state
# builds: their default, whatever cfg.eps (1e-3 under use_bf16) says; the
# loss and AdamW take cfg.eps
MODEL_EPS = 1e-6


def build_model(cfg: Config, seed: Optional[int] = 0,
                device: DeviceLike = None, with_images: bool = True
                ) -> Union[MVXNetPM, VoxelNetBranchPM]:
    """The detector ``cfg`` describes, with random weights drawn from
    ``seed`` (None leaves PyTorch's default initialization), on
    ``device`` (default: the CUDA card): :class:`MVXNetPM`, or with
    ``with_images=False`` the LiDAR-only ``VoxelNetBranchPM`` on the 7
    LiDAR channels.  Its parameters are float32 whatever ``use_bf16``
    says: they are the masters the bfloat16 forward is cast from
    (``train.state.cast_for_compute``)."""
    dev = resolve_device(device)
    if cfg.fusion_mode != "pm" or cfg.cml_mode not in ("column", "dense3d"):
        raise NotImplementedError(
            "the port implements fusion_mode='pm' with cml_mode 'column' "
            "or 'dense3d'")
    if cfg.norm_scope != "sample":
        raise NotImplementedError(
            "the port implements norm_scope='sample' only")
    if with_images:
        model = MVXNetPM(grid_shape=cfg.voxel_shape,
                         image_size=cfg.image_size,
                         anchors_per_loc=cfg.anchors_per_loc,
                         box_dim=cfg.box_dim, eps=MODEL_EPS,
                         swapped_bilerp=cfg.compat_swapped_bilerp,
                         samples_per_voxel=cfg.samples_per_voxel,
                         image_min_side=cfg.image_min_side,
                         rpn_trunk=cfg.rpn_trunk, cml_mode=cfg.cml_mode,
                         scatter_backend=cfg.scatter_backend,
                         remat=cfg.remat)
    else:
        model = VoxelNetBranchPM(
            7, cfg.voxel_shape, cfg.anchors_per_loc, cfg.box_dim, MODEL_EPS,
            cfg.samples_per_voxel, cfg.rpn_trunk, cfg.cml_mode,
            cfg.scatter_backend, cfg.remat)
    if seed is not None:
        from mvxnet_makise_tpu_torch.models.weights import init_weights

        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
