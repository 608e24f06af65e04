"""Typed configuration: the port's copy of ``mvxnet_makise_tpu.config``.

Same fields, defaults, derived quantities and ``__post_init__`` validation,
so a configuration means the same model in both packages.  Some fields
select formulations that only the JAX package has; the port keeps them
for interchange and builds the function each computes
(``models/mvxnet.build_model``):

* ``fusion_mode``: "pm" (the default), "slot" (JAX's ``MVXNet``, over the
  (V, T, C) slot tensor) and "point" (``MVXNetPointFusion``) compute one
  function on one parameter tree, and all build the point-major
  ``MVXNetPM``; "voxel" builds ``MVXNetVoxelFusion``, the one that
  computes another function.  No slot tensor, banded scatter or per-slot
  gather is ported;
* ``cml_mode``: "column" (K1) and "dense3d" (the grid scatter, K4 under
  ``scatter_backend="pallas"``); "banded", the dense CML's conv1 in a
  depth-banded layout, builds the column CML;
* ``gather_backend`` and ``fusion_stats`` select layouts of the one FPN
  gather (K2) and the one fusion-MLP statistics the port computes.

``norm_scope`` "sample" normalizes each sample with its own statistics,
"batch" over the whole batch (``models/blocks.set_norm_scope``).
``use_bf16`` computes in bfloat16 from float32 parameters
(``train/state.cast_for_compute``); ``remat`` recomputes the CML in the
backward pass (``models/voxelnet_pm``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple

import yaml

from mvxnet_makise_tpu_torch.ops.assign import min_assign_window


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- geometry of the scene ----
    # (x_min, y_min, z_min, x_max, y_max, z_max) in LiDAR metres.
    velo_range: Tuple[float, float, float, float, float, float] = (
        0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    # voxel grid extent (nx, ny, nz).
    voxel_shape: Tuple[int, int, int] = (352, 400, 10)
    # anchor box size (l, w, h).
    car_size: Tuple[float, float, float] = (3.9, 1.6, 1.56)
    # camera image size (h, w).
    image_size: Tuple[int, int] = (370, 1224)

    # ---- sampling / capacity ----
    # points kept per voxel.
    samples_per_voxel: int = 35
    # point-cloud capacity per frame; the host feed subsamples a denser
    # frame at random.
    max_points: int = 24576
    # voxel capacity per frame.
    max_voxels: int = 12288
    # GT-box capacity per frame.
    max_boxes: int = 32

    # ---- model ----
    # channels of the per-point image feature (MVX PointFusion).
    image_feature_dim: int = 16
    # per-anchor regression dim (x y z l w h r).
    box_dim: int = 7
    # per-class anchor (l, w, h); None = standard KITTI sizes per class.
    anchor_sizes: Optional[Tuple[Tuple[float, float, float], ...]] = None

    # ---- target assignment ----
    neg_iou_threshold: float = 0.45
    pos_iou_threshold: float = 0.6
    # half-width (in anchor cells) of the IoU window around each GT.
    assign_window: int = 12
    assign_best_anchor_fallback: bool = False

    # ---- training ----
    batch_size: int = 1
    learning_rate: float = 1e-3
    lr_schedule: str = "constant"      # "constant" | "cosine"
    lr_warmup_steps: int = 200
    lr_decay_steps: int = 10_000
    num_epochs: int = 10
    pos_loss_weight: float = 1.5
    neg_loss_weight: float = 1.0
    cls_loss_mode: str = "reference"   # "reference" | "focal"
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    # compute in bfloat16 from float32 parameters (train/state.py).
    use_bf16: bool = False
    # stateless-norm statistics scope: "sample" = every sample normalized
    # with its own statistics (the reference's batch-1 semantics);
    # "batch" = statistics over the whole batch.
    norm_scope: str = "sample"
    seed: int = 0
    checkpoint_dir: str = "./checkpoints"
    checkpoint_keep_last: int = 0

    # ---- data ----
    data_root: str = "./data/kitti"
    target_classes: Tuple[str, ...] = ("Car",)
    augment_fill_to: Tuple[int, ...] = (12,)
    num_workers: int = 8

    # ---- parallelism ----
    mesh_shape: Tuple[int, int] = (1, 1)

    # CML form: "column" (K1), "banded" (built as "column") or "dense3d"
    # (scatter, then dense 3-D convs); the dense scatter is K4 under
    # "pallas", else plain PyTorch.
    scatter_backend: str = "auto"
    cml_mode: str = "column"
    # JAX-side formulation switches, kept for interchange (module
    # docstring): the port computes the same function whatever they say.
    gather_backend: str = "auto"
    fusion_stats: str = "auto"

    # detection-transform min side (torchvision GeneralizedRCNNTransform:
    # 800 with a 1333 max-side cap, which binds at KITTI aspect: 370x1224
    # scales by 1333/1224 to 402x1332, padded to 416x1344).  <= 0 = native
    # scale (pad only).  Non-default values use a content-correct
    # pixel->feature-cell mapping (models/image_head.gather_image_size).
    image_min_side: float = 800.0

    # RPN trunk: per-stage channels, per-stage extra 3x3 convs after the
    # stride-2 down conv, and the deconv width (reference shape:
    # (128, 128, 256) / (3, 5, 5) / 256).
    rpn_channels: Tuple[int, int, int] = (128, 128, 256)
    rpn_extra: Tuple[int, int, int] = (3, 5, 5)
    rpn_deconv_channels: int = 256

    # recompute the CML in the backward pass instead of keeping its
    # activations (torch.utils.checkpoint).
    remat: bool = False

    # image-branch dataflow: "pm" | "slot" | "point" | "voxel" (module
    # docstring).
    fusion_mode: str = "pm"

    # the reference's bilinear gather swaps the interpolation weights vs
    # the textbook formula; True reproduces it.
    compat_swapped_bilerp: bool = False

    # ---- derived (filled in __post_init__) ----
    voxel_size: Tuple[float, float, float] = dataclasses.field(init=False)
    eps: float = dataclasses.field(init=False)
    feature_map_shape: Tuple[int, int] = dataclasses.field(init=False)
    class_neg_thresholds: Tuple[float, ...] = dataclasses.field(init=False)
    class_pos_thresholds: Tuple[float, ...] = dataclasses.field(init=False)

    def __post_init__(self):
        if self.fusion_stats not in ("auto", "masked", "full"):
            raise ValueError(
                f"fusion_stats={self.fusion_stats!r} — must be 'auto', "
                f"'masked' or 'full'")
        if self.norm_scope not in ("sample", "batch"):
            raise ValueError(
                f"norm_scope={self.norm_scope!r} — must be 'sample' "
                f"(reference batch-1 semantics) or 'batch'")
        if not (len(self.rpn_channels) == len(self.rpn_extra) == 3):
            raise ValueError("rpn_channels/rpn_extra must have 3 stages")
        object.__setattr__(self, "rpn_channels",
                           tuple(int(c) for c in self.rpn_channels))
        object.__setattr__(self, "rpn_extra",
                           tuple(int(c) for c in self.rpn_extra))
        vr, vs = self.velo_range, self.voxel_shape
        object.__setattr__(
            self, "voxel_size",
            tuple((vr[i + 3] - vr[i]) / vs[i] for i in range(3)))
        # eps 1e-3 under half precision, 1e-6 under fp32 (reference).
        object.__setattr__(self, "eps", 1e-3 if self.use_bf16 else 1e-6)
        # RPN output grid: voxel grid / 2.
        object.__setattr__(
            self, "feature_map_shape", (vs[0] // 2, vs[1] // 2))
        if self.anchor_sizes is None:
            object.__setattr__(self, "anchor_sizes", tuple(
                _DEFAULT_CLASS_SIZES.get(c, tuple(self.car_size))
                for c in self.target_classes))
        thr = tuple(
            _DEFAULT_CLASS_THRESHOLDS.get(
                c, (self.neg_iou_threshold, self.pos_iou_threshold))
            for c in self.target_classes)
        object.__setattr__(
            self, "class_neg_thresholds", tuple(t[0] for t in thr))
        object.__setattr__(
            self, "class_pos_thresholds", tuple(t[1] for t in thr))
        # the windowed assignment equals the reference's unbounded spiral
        # only while the window covers every anchor that can reach
        # IoU >= neg_threshold
        for size, neg in zip(self.anchor_sizes, self.class_neg_thresholds):
            req = min_assign_window(self.feature_map_shape, vr, size, neg)
            if self.assign_window < req:
                raise ValueError(
                    f"assign_window={self.assign_window} under-covers "
                    f"anchors of footprint {size[:2]} at neg IoU "
                    f"threshold {neg} on a {self.feature_map_shape} grid "
                    f"— need >= {req} cells for spiral-parity")

    # -- convenience --
    @property
    def point_fusion(self) -> bool:
        return self.fusion_mode == "point"

    @property
    def num_classes(self) -> int:
        return len(self.target_classes)

    @property
    def rpn_trunk(self) -> Tuple:
        """((ch1, ch2, ch3), (e1, e2, e3), deconv_ch) for the RPN."""
        return (self.rpn_channels, self.rpn_extra,
                int(self.rpn_deconv_channels))

    @property
    def anchors_per_loc(self) -> int:
        """Total anchor slots per BEV cell: 2 yaws per class."""
        return 2 * self.num_classes

    @property
    def num_anchors(self) -> int:
        h, w = self.feature_map_shape
        return h * w * self.anchors_per_loc

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# standard KITTI anchor footprints and match thresholds per class
_DEFAULT_CLASS_SIZES = {
    "Car": (3.9, 1.6, 1.56),
    "Pedestrian": (0.8, 0.6, 1.73),
    "Cyclist": (1.76, 0.6, 1.73),
}
_DEFAULT_CLASS_THRESHOLDS = {
    "Car": (0.45, 0.6),
    "Pedestrian": (0.35, 0.5),
    "Cyclist": (0.35, 0.5),
}


_YAML_KEYS = {
    # reference config.yml key -> Config field
    "velorange": "velo_range",
    "voxelshape": "voxel_shape",
    "carsize": "car_size",
    "imsize": "image_size",
    "samplenum": "samples_per_voxel",
    "batchsize": "batch_size",
}


def load_config(path: Optional[str] = None, **overrides) -> Config:
    """Build a Config, optionally from a YAML file.

    Accepts both this framework's field names and the reference's
    config.yml key names (so a reference config file loads directly).
    """
    kw = {}
    if path is not None and os.path.exists(path):
        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        fields = {f.name for f in dataclasses.fields(Config) if f.init}
        for k, v in raw.items():
            k = _YAML_KEYS.get(k, k)
            if k in fields:
                kw[k] = tuple(v) if isinstance(v, list) else v
    kw.update(overrides)
    return Config(**kw)


def parse_cli(argv=None) -> Tuple[Config, argparse.Namespace]:
    """The reference's training command line (positional dataroot,
    -n/--numepochs, -r/--resume) plus --config (a YAML path for
    :func:`load_config`), --batch-size and --bf16: the ``Config`` those
    arguments give, and the parsed arguments.  ``tools.train`` has a
    parser of its own with the device and data options."""
    p = argparse.ArgumentParser(description="MVXNet-Makise training")
    p.add_argument("dataroot", nargs="?", default=None)
    p.add_argument("-n", "--numepochs", type=int, default=10)
    p.add_argument("-r", "--resume", type=int, default=0,
                   help="epoch number to resume from")
    p.add_argument("--config", type=str, default=None,
                   help="optional YAML config path")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--bf16", action="store_true")
    args = p.parse_args(argv)

    overrides = {"num_epochs": args.numepochs}
    if args.dataroot:
        overrides["data_root"] = args.dataroot
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.bf16:
        overrides["use_bf16"] = True
    return load_config(args.config, **overrides), args
