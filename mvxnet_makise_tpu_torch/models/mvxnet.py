"""The fused detectors: MVXNetPM (PointFusion) and MVXNetVoxelFusion.

Port of ``MVXNetPM`` and ``MVXNetVoxelFusion``
(``mvxnet_makise_tpu/models/mvxnet.py``).  ``MVXNetPM``: per-point image
features (``head``) concatenated with the 7 LiDAR channels feed the
point-major LiDAR branch (``backbone``); the empty sample slots of each
voxel enter with the zero LiDAR row and the image branch's empty-slot
feature (``z0``).  ``MVXNetVoxelFusion``: the MVX-Net paper's VoxelFusion,
one image feature per voxel, gathered at the mean image projection of
its points and fused after the LiDAR voxel encoding.  Both take the same
seven point-major inputs.  :func:`build_model` also builds the LiDAR-only
detector, ``VoxelNetBranchPM`` on the 7 LiDAR channels alone.  Spans
(``utils/profiling``): ``mvx.model.image`` (ResNet50-FPN, K2, the fusion
MLP), ``mvx.model.vfe``, ``mvx.model.cml``, ``mvx.model.rpn``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.device import DeviceLike, resolve_device
from mvxnet_makise_tpu_torch.models.blocks import (
    DenseReluNorm,
    DenseReluNormVirtualWeighted,
    set_norm_scope,
)
from mvxnet_makise_tpu_torch.models.image_head import (
    PointImageHead,
    fpn_pyramid,
    gather_image_size,
)
from mvxnet_makise_tpu_torch.models.resnet_fpn import ResNet50FPN
from mvxnet_makise_tpu_torch.models.voxelnet import (
    REFERENCE_RPN_TRUNK,
    RPN,
    make_cml,
)
from mvxnet_makise_tpu_torch.models.voxelnet_pm import (
    PointSVFE,
    VoxelNetBranchPM,
    point_lidar_features,
    segment_sum,
    voxel_features,
)
from mvxnet_makise_tpu_torch.ops.gather import fpn_gather
from mvxnet_makise_tpu_torch.utils.profiling import span


class MVXNetPM(nn.Module):
    def __init__(self, grid_shape=(352, 400, 10),
                 image_size: Tuple[int, int] = (370, 1224),
                 anchors_per_loc: int = 2, box_dim: int = 7,
                 eps: float = 1e-6, swapped_bilerp: bool = False,
                 samples_per_voxel: int = 35,
                 image_min_side: float = 800.0,
                 rpn_trunk: Tuple = REFERENCE_RPN_TRUNK,
                 cml_mode: str = "column", scatter_backend: str = "auto",
                 remat: bool = False, origin_is_empty: bool = False):
        super().__init__()
        self.samples_per_voxel = samples_per_voxel
        self.origin_is_empty = origin_is_empty
        self.head = PointImageHead(image_size, eps, swapped_bilerp,
                                   image_min_side)
        self.backbone = VoxelNetBranchPM(
            7 + 16, grid_shape, anchors_per_loc, box_dim, eps,
            samples_per_voxel, rpn_trunk, cml_mode, scatter_backend, remat)

    def fused_inputs(self, sorted_points, sorted_kept, sorted_seg, counts,
                     vmask, images):
        """Per-point 23-channel inputs of the LiDAR branch and the
        empty-slot row per voxel: (x (B, P, 23), z0 (B, V, 23)).  With
        ``origin_is_empty`` a kept point at x = y = z = 0 enters the image
        branch as an empty slot: not gathered, counted among the virtual
        rows, its image feature the empty-slot feature."""
        B, V = counts.shape
        seen = sorted_kept
        if self.origin_is_empty:
            seen = sorted_kept & (sorted_points[..., :3] != 0).any(dim=-1)
        # per sample; batch-wide norms pool it with their sums, which
        # gives JAX's batch total (blocks._moments)
        n_virtual = (vmask.sum(dim=1) * self.samples_per_voxel
                     - seen.sum(dim=1))
        with span("mvx.model.image"):
            imfeat, z16 = self.head(images, sorted_points[..., 4:6], seen,
                                    n_virtual)
            if self.origin_is_empty:
                imfeat = torch.where(seen[..., None], imfeat,
                                     z16[:, None, :].expand_as(imfeat))
        with span("mvx.model.vfe"):
            pf7 = point_lidar_features(sorted_points, sorted_seg,
                                       sorted_kept, counts,
                                       self.samples_per_voxel)
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


# channels of VoxelFusion's per-voxel image feature (JAX's
# MVXNetVoxelFusion.voxel_image_dim, which no configuration sets)
VOXEL_IMAGE_DIM = 32


class MVXNetVoxelFusion(nn.Module):
    """VoxelFusion: LiDAR-only voxel encoding (``svfe``, ``fcn``), then one
    image feature per voxel — the frozen ResNet50-FPN (``extractor``), K2
    at the voxel's mean image projection, ``imfuse1`` 768 -> 128 and
    ``imfuse2`` 128 -> 32 — concatenated and mixed to
    128 channels (``mix``), then the CML and the RPN.  Attributes follow
    JAX's parameter tree."""

    def __init__(self, grid_shape=(352, 400, 10),
                 image_size: Tuple[int, int] = (370, 1224),
                 anchors_per_loc: int = 2, box_dim: int = 7,
                 eps: float = 1e-6, samples_per_voxel: int = 35,
                 image_min_side: float = 800.0,
                 rpn_trunk: Tuple = REFERENCE_RPN_TRUNK,
                 cml_mode: str = "column", scatter_backend: str = "auto"):
        super().__init__()
        self.samples_per_voxel = samples_per_voxel
        self.image_size = tuple(image_size)
        self.image_min_side = image_min_side
        self.eps = eps
        self.svfe = PointSVFE(7, eps)
        self.fcn = DenseReluNormVirtualWeighted(128, 128, eps)
        self.extractor = ResNet50FPN()
        self.imfuse1 = DenseReluNorm(768, 128, eps)
        self.imfuse2 = DenseReluNorm(128, VOXEL_IMAGE_DIM, eps)
        self.mix = DenseReluNorm(128 + VOXEL_IMAGE_DIM, 128, eps)
        self.cml = make_cml(cml_mode, 128, grid_shape, eps, scatter_backend)
        self.rpn = RPN(64 * 2, anchors_per_loc, box_dim, eps, rpn_trunk)

    def voxel_points(self, sorted_points, sorted_kept, sorted_seg, counts,
                     dtype: torch.dtype) -> torch.Tensor:
        """Per-voxel (row, col) (B, V, 2): the mean projection of the
        voxel's points, in ``dtype``.  As in JAX, a point counts when any
        of its x, y, z is nonzero, the mean divides by max(count, 1), and
        the points are rounded to ``dtype`` first (JAX rounds the whole
        slot tensor to the compute dtype); the sums run in at least
        float32, as JAX's do."""
        pts = sorted_points.to(dtype)
        acc = torch.promote_types(dtype, torch.float32)
        w = ((pts[..., :3] != 0).any(dim=-1) & sorted_kept).to(acc)
        sums = segment_sum(
            torch.cat([pts[..., 4:6].to(acc) * w[..., None],
                       w[..., None]], dim=-1),
            sorted_seg, sorted_kept, counts, self.samples_per_voxel)
        sums = sums.to(dtype)
        return sums[..., :2] / torch.clamp(sums[..., 2:], min=1)

    def forward(self, sorted_points: torch.Tensor,
                sorted_kept: torch.Tensor, sorted_seg: torch.Tensor,
                counts: torch.Tensor, coords: torch.Tensor,
                vmask: torch.Tensor, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The inputs of :meth:`MVXNetPM.forward`; the same maps out.  The
        compute dtype is the images' (bfloat16 under ``use_bf16``)."""
        cdt = images.dtype
        with span("mvx.model.vfe"):
            pf7 = point_lidar_features(sorted_points, sorted_seg,
                                       sorted_kept, counts,
                                       self.samples_per_voxel)
            x = voxel_features(self.svfe, self.fcn, self.samples_per_voxel,
                               pf7.to(cdt), sorted_kept, sorted_seg, counts,
                               vmask)
        with span("mvx.model.image"):
            rc = self.voxel_points(sorted_points, sorted_kept, sorted_seg,
                                   counts, cdt)
            pyramid = fpn_pyramid(self.extractor, images,
                                  self.image_min_side)
            gathered = fpn_gather(
                pyramid, rc.to(torch.promote_types(cdt, torch.float32))
                .contiguous(), vmask.contiguous(),
                gather_image_size(self.image_size, self.image_min_side),
                eps=self.eps)                               # (B, V, 768)
            imf = self.imfuse2(self.imfuse1(gathered, vmask), vmask)
            fused = self.mix(torch.cat([x, imf], dim=-1), vmask)
            fused = torch.where(vmask[..., None], fused,
                                torch.zeros_like(fused))
        with span("mvx.model.cml"):
            y = self.cml(fused, coords, vmask)      # (B, C, D, nx, ny)
        B, C, D, H, W = y.shape
        with span("mvx.model.rpn"):
            return self.rpn(y.reshape(B, C * D, H, W))


FUSION_MODES = ("pm", "slot", "point", "voxel")


# the norms' eps of the models JAX's train/loop.build_model_and_state
# builds: their default, whatever cfg.eps (1e-3 under use_bf16) says; the
# loss and AdamW take cfg.eps
MODEL_EPS = 1e-6


def build_model(cfg: Config, seed: Optional[int] = 0,
                device: DeviceLike = None, with_images: bool = True
                ) -> Union[MVXNetPM, MVXNetVoxelFusion, VoxelNetBranchPM]:
    """The detector ``cfg`` describes, with random weights drawn from
    ``seed`` (None leaves PyTorch's default initialization), on
    ``device`` (default: the CUDA card), its norms set to
    ``cfg.norm_scope``.  Its parameters are float32 whatever ``use_bf16``
    says: they are the masters the bfloat16 forward is cast from
    (``train.state.cast_for_compute``).

    ``fusion_mode`` "pm", and JAX's "slot" (``MVXNet``) and "point"
    (``MVXNetPointFusion``), which compute ``MVXNetPM``'s function on its
    parameter tree, build :class:`MVXNetPM` ("slot" with
    ``origin_is_empty``: JAX's ``MVXNet`` takes a sample at x = y = z = 0
    for an empty slot of the image branch); "voxel" builds
    :class:`MVXNetVoxelFusion`, as JAX does without ``remat``,
    ``compat_swapped_bilerp``, ``gather_backend`` or ``fusion_stats``.
    ``cml_mode`` "banded" builds the column CML (``voxelnet.make_cml``).
    With ``with_images=False``: the LiDAR-only ``VoxelNetBranchPM`` on
    the 7 LiDAR channels, also the port of JAX's slot-major
    ``VoxelNetBranch`` that the other fusion modes build."""
    if cfg.fusion_mode not in FUSION_MODES:
        raise ValueError(f"unknown fusion_mode {cfg.fusion_mode!r}: one of "
                         f"{FUSION_MODES}")
    dev = resolve_device(device)
    common = dict(grid_shape=cfg.voxel_shape, image_size=cfg.image_size,
                  anchors_per_loc=cfg.anchors_per_loc, box_dim=cfg.box_dim,
                  eps=MODEL_EPS, samples_per_voxel=cfg.samples_per_voxel,
                  image_min_side=cfg.image_min_side,
                  rpn_trunk=cfg.rpn_trunk, cml_mode=cfg.cml_mode,
                  scatter_backend=cfg.scatter_backend)
    if with_images and cfg.fusion_mode == "voxel":
        model = MVXNetVoxelFusion(**common)
    elif with_images:
        model = MVXNetPM(swapped_bilerp=cfg.compat_swapped_bilerp,
                         remat=cfg.remat,
                         origin_is_empty=cfg.fusion_mode == "slot",
                         **common)
    else:
        model = VoxelNetBranchPM(
            7, cfg.voxel_shape, cfg.anchors_per_loc, cfg.box_dim, MODEL_EPS,
            cfg.samples_per_voxel, cfg.rpn_trunk, cfg.cml_mode,
            cfg.scatter_backend, cfg.remat)
    set_norm_scope(model, cfg.norm_scope)
    if seed is not None:
        from mvxnet_makise_tpu_torch.models.weights import init_weights

        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def image_extractor(model: nn.Module) -> Optional[ResNet50FPN]:
    """The frozen ResNet50-FPN of a fused model; None for the LiDAR-only
    one."""
    if isinstance(model, MVXNetVoxelFusion):
        return model.extractor
    if isinstance(model, MVXNetPM):
        return model.head.extractor.backbone
    return None
