"""The plain reference of MVX-Net PointFusion and its VoxelNet branch:
one frame at a time, slot-major, dense, in the dtype it is given (the
benchmark runs it in float32 with TF32 off).

It follows the published models (MVX-Net, arXiv:1904.01649, PointFusion;
VoxelNet, arXiv:1711.06396) as the configurations state them, and imports
nothing of the program:

- voxelization of a padded cloud: voxel index ``floor((xyz - low) / size)``
  in float32 (the configuration's geometry is float32), voxels in
  ascending linear index, at most ``max_voxels`` of them, and the first
  ``samples_per_voxel`` points of each in cloud order;
- the image branch: ImageNet normalisation, an antialiased bilinear resize
  to a 800-pixel short side capped at 1333, zero padding to a multiple of
  32, ResNet50 with frozen (affine) norms, FPN v2 levels 0..2, a bilinear
  sample of each level at each kept point's projection, and the 768 -> 16
  fusion MLP over every slot of every voxel (an empty slot's input is 0);
- the VFE stack over the (V, T, C) slot tensor (an empty slot's LiDAR
  input is 0): Linear, ReLU, standardisation over every slot of the
  frame's voxels, max over the slots, concatenation;
- the dense middle layers: the voxel features scattered into the
  (128, 10, 352, 400) grid and three 3x3x3 convolutions, each with ReLU
  and standardisation over the frame;
- the RPN: three stride-2 stages, three transposed convolutions, 1x1
  heads, the score through a sigmoid;
- box decoding against the anchor grid.

Every norm of these models is a stateless standardisation (BatchNorm
without affine or running statistics, after the ReLU), per frame: the
reference runs each frame alone, which is its definition.

Parameters come as a dict keyed as the program's state dict names them
(:func:`param_spec`), so one set of weights, made by the benchmark from
the seed, is handed to both sides.

``quant``: a function applied to both operands of every matrix product and
convolution.  The identity gives the reference; a rounding to float8
gives the control the benchmark's limits are held against.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RESNET_STAGES = (3, 4, 6, 3)
NORM_EPS = 1e-6
# the bias of every layer followed by ReLU and a standardisation
# (make_params)
ACT_BIAS = 1.0


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _resnet_fpn_spec(prefix: str) -> List[Tuple[str, Tuple[int, ...], str]]:
    spec = [(f"{prefix}body.conv1.weight", (64, 3, 7, 7), "conv"),
            *_affine(f"{prefix}body.bn1", 64)]
    cin, width = 64, 64
    for li, blocks in enumerate(RESNET_STAGES):
        for bi in range(blocks):
            p = f"{prefix}body.layer{li + 1}.{bi}"
            spec += [(f"{p}.conv1.weight", (width, cin, 1, 1), "conv"),
                     *_affine(f"{p}.bn1", width),
                     (f"{p}.conv2.weight", (width, width, 3, 3), "conv"),
                     *_affine(f"{p}.bn2", width),
                     (f"{p}.conv3.weight", (width * 4, width, 1, 1), "conv"),
                     *_affine(f"{p}.bn3", width * 4, residual=True)]
            if bi == 0:
                spec += [(f"{p}.downsample.0.weight", (width * 4, cin, 1, 1),
                          "conv"),
                         *_affine(f"{p}.downsample.1", width * 4)]
            cin = width * 4
        width *= 2
    for i, c in enumerate((256, 512, 1024, 2048)):
        spec += [(f"{prefix}fpn.inner_blocks.{i}.0.weight", (256, c, 1, 1),
                  "conv"), *_affine(f"{prefix}fpn.inner_blocks.{i}.1", 256)]
    for i in range(3):
        spec += [(f"{prefix}fpn.layer_blocks.{i}.0.weight", (256, 256, 3, 3),
                  "conv"), *_affine(f"{prefix}fpn.layer_blocks.{i}.1", 256)]
    return spec


def _affine(name: str, c: int, residual: bool = False):
    kind = "norm_scale_residual" if residual else "norm_scale"
    return [(f"{name}.scale", (c,), kind), (f"{name}.bias", (c,), "zero")]


def _dense(name: str, cin: int, cout: int):
    return [(f"{name}.weight", (cout, cin), "dense"),
            (f"{name}.bias", (cout,), "act_bias")]


def _lidar_spec(prefix: str, cin: int, anchors: int = 2,
                box_dim: int = 7) -> list:
    spec = (_dense(f"{prefix}svfe.vfe1.fcn.fc", cin, 16)
            + _dense(f"{prefix}svfe.vfe2.fcn.fc", 32, 64)
            + _dense(f"{prefix}fcn.fc", 128, 128))
    for i, c in ((1, 128), (2, 64), (3, 64)):
        spec += [(f"{prefix}cml.conv{i}.conv.weight", (64, c, 3, 3, 3),
                  "conv"), (f"{prefix}cml.conv{i}.conv.bias", (64,), "act_bias")]
    blocks = (("blk1", 128, 128, 3), ("blk2", 128, 128, 5),
              ("blk3", 128, 256, 5))
    for name, cin_b, ch, extra in blocks:
        for j in range(extra + 1):
            spec += [(f"{prefix}rpn.{name}.{j}.conv.weight",
                      (ch, cin_b if j == 0 else ch, 3, 3), "rpn"),
                     (f"{prefix}rpn.{name}.{j}.conv.bias", (ch,),
                      "act_bias")]
    for name, cin_d, k in (("deconv1", 128, 3), ("deconv2", 128, 2),
                           ("deconv3", 256, 4)):
        spec += [(f"{prefix}rpn.{name}.deconv.weight", (cin_d, 256, k, k),
                  "rpn_t"), (f"{prefix}rpn.{name}.deconv.bias", (256,),
                             "act_bias")]
    spec += [(f"{prefix}rpn.cls.weight", (anchors, 768, 1, 1), "rpn"),
             (f"{prefix}rpn.cls.bias", (anchors,), "zero"),
             (f"{prefix}rpn.reg.weight", (anchors * box_dim, 768, 1, 1),
              "rpn"),
             (f"{prefix}rpn.reg.bias", (anchors * box_dim,), "zero")]
    return spec


def param_spec(with_images: bool) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter of the model: MVX-Net
    PointFusion with images, the VoxelNet branch alone without."""
    if not with_images:
        return _lidar_spec("", 7)
    fusion = []
    cin = 768
    for name, width in (("fcn1", 768), ("conv1", 128), ("fcn2", 128),
                        ("conv2", 16), ("fcn3", 16)):
        fusion += _dense(f"head.fusion.{name}.fc", cin, width)
        cin = width
    return (_resnet_fpn_spec("head.extractor.backbone.") + fusion
            + _lidar_spec("backbone.", 23))


def is_frozen(name: str) -> bool:
    """The image trunk is frozen: trained by nobody, updated by nothing."""
    return "extractor" in name.split(".")


def make_params(spec, seed: int, device) -> Params:
    """Random weights from ``seed``, drawn on ``device`` in a few large
    calls: LeCun-normal dense and convolution kernels, Xavier-uniform RPN
    kernels, unit folded-norm scales (0.25 on each bottleneck's last norm,
    which keeps the residual stream of the untrained trunk from growing
    block by block), zero biases in the trunk and the heads.

    Each layer followed by a ReLU and a standardisation gets the bias
    ``ACT_BIAS``, one standard deviation of its pre-activation: its ReLU
    then passes most of it.  With zero biases the untrained stack of
    ReLU-and-standardise layers is chaotic: bfloat16 rounding of the
    weights alone moves the LiDAR branch's regression maps by 14 % on
    average and its scores by up to 0.5 (measured on the CPU at the full
    grid), as far as a wrong answer would.  A trained detector is not
    chaotic; with these biases the same rounding moves the maps by 1.8 %
    and a float8 rounding by 41 %, so a comparison can tell the two
    apart."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(np.prod(s)) for _, s, _ in spec]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out: Params = {}
    off = 0
    for (name, shape, kind), n in zip(spec, sizes):
        if kind in ("dense", "conv"):
            fan_in = int(np.prod(shape[1:]))
            t = normal[off:off + n] / math.sqrt(fan_in)
        elif kind in ("rpn", "rpn_t"):
            rf = int(np.prod(shape[2:]))
            fan_in, fan_out = shape[1] * rf, shape[0] * rf
            t = uniform[off:off + n] * math.sqrt(6.0 / (fan_in + fan_out))
        elif kind == "norm_scale":
            t = torch.ones(n, device=device)
        elif kind == "act_bias":
            t = torch.full((n,), ACT_BIAS, device=device)
        elif kind == "norm_scale_residual":
            t = torch.full((n,), 0.25, device=device)
        else:
            t = torch.zeros(n, device=device)
        out[name] = t.reshape(shape).contiguous()
        off += n
    return out


# ---------------------------------------------------------------------------
# voxelization
# ---------------------------------------------------------------------------

class Voxels(NamedTuple):
    """One frame's voxels: V real voxels, T slots each."""
    slots: torch.Tensor    # (V, T, 6) points; empty slots 0
    filled: torch.Tensor   # (V, T) bool
    coords: torch.Tensor   # (V, 3) long (ix, iy, iz)


def voxelize(points: torch.Tensor, n: int, velo_range, grid_shape,
             max_voxels: int, samples: int) -> Voxels:
    """points: (P, 6) padded cloud, the first ``n`` rows real."""
    dev = points.device
    pts = points[:n]
    lo = torch.tensor(velo_range[:3], dtype=torch.float32, device=dev)
    hi_m = torch.tensor(velo_range[3:6], dtype=torch.float64)
    size = ((hi_m - torch.tensor(velo_range[:3], dtype=torch.float64))
            / torch.tensor(grid_shape, dtype=torch.float64))
    size = size.to(torch.float32).to(dev)
    ijk = torch.floor((pts[:, :3] - lo) / size).long()
    dims = torch.tensor(grid_shape, device=dev)
    inside = ((ijk >= 0) & (ijk < dims)).all(dim=1)
    pts, ijk = pts[inside], ijk[inside]
    nx, ny, nz = grid_shape
    lin = (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]
    order = torch.sort(lin, stable=True).indices
    lin, pts = lin[order], pts[order]
    cells, voxel, counts = torch.unique_consecutive(
        lin, return_inverse=True, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(lin), device=dev) - starts[voxel]
    keep = (rank < samples) & (voxel < max_voxels)
    V = min(len(cells), max_voxels)
    slots = torch.zeros((V, samples, 6), dtype=points.dtype, device=dev)
    filled = torch.zeros((V, samples), dtype=torch.bool, device=dev)
    slots[voxel[keep], rank[keep]] = pts[keep]
    filled[voxel[keep], rank[keep]] = True
    cells = cells[:V]
    coords = torch.stack([cells // (ny * nz), (cells // nz) % ny,
                          cells % nz], dim=1)
    return Voxels(slots, filled, coords)


def lidar_features(vox: Voxels) -> torch.Tensor:
    """(V, T, 7) [x y z, offsets from the voxel's centroid, reflectance]
    of each filled slot; empty slots 0."""
    xyz = vox.slots[..., :3]
    m = vox.filled[..., None].to(xyz.dtype)
    count = m.sum(dim=1).clamp(min=1)
    centroid = (xyz * m).sum(dim=1) / count
    f = torch.cat([xyz, xyz - centroid[:, None], vox.slots[..., 3:4]],
                  dim=-1)
    return f * m


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def standardize(x: torch.Tensor, dims, eps: float = NORM_EPS):
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def linear(x, P: Params, name: str, q: Quant):
    return F.linear(q(x), q(P[name + ".weight"]), P[name + ".bias"])


def dense_relu_norm(x, P, name, q, rows_dims=(0, 1)):
    return standardize(torch.relu(linear(x, P, name, q)), rows_dims)


def conv2d(x, P, name, q, stride=1, padding=0, bias=True):
    return F.conv2d(q(x), q(P[name + ".weight"]),
                    P[name + ".bias"] if bias else None, stride, padding)


def affine(x, P, name):
    return x * P[name + ".scale"][:, None, None] + P[name + ".bias"][:, None,
                                                                      None]


def resnet_fpn(x: torch.Tensor, P: Params, q: Quant,
               prefix: str = "head.extractor.backbone.") -> List[torch.Tensor]:
    """(1, 3, H, W) -> FPN levels 0..2, each (1, 256, H/s, W/s)."""
    b = prefix + "body."
    x = torch.relu(affine(conv2d(x, P, b + "conv1", q, 2, 3, False), P,
                          b + "bn1"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    feats = []
    for li, blocks in enumerate(RESNET_STAGES):
        for bi in range(blocks):
            p = f"{b}layer{li + 1}.{bi}."
            stride = 2 if (bi == 0 and li > 0) else 1
            y = torch.relu(affine(conv2d(x, P, p + "conv1", q, bias=False),
                                  P, p + "bn1"))
            y = torch.relu(affine(conv2d(y, P, p + "conv2", q, stride, 1,
                                         bias=False), P, p + "bn2"))
            y = affine(conv2d(y, P, p + "conv3", q, bias=False), P,
                       p + "bn3")
            skip = x
            if bi == 0:
                skip = affine(conv2d(x, P, p + "downsample.0", q, stride,
                                     bias=False), P, p + "downsample.1")
            x = torch.relu(y + skip)
        feats.append(x)
    f = prefix + "fpn."
    lat = [affine(conv2d(t, P, f"{f}inner_blocks.{i}.0", q, bias=False), P,
                  f"{f}inner_blocks.{i}.1") for i, t in enumerate(feats)]
    merged = lat[3]
    outs = [None, None, None, merged]
    for i in (2, 1, 0):
        h, w = lat[i].shape[-2:]
        up = F.interpolate(merged, scale_factor=2, mode="nearest")
        merged = lat[i] + up[..., :h, :w]
        outs[i] = merged
    return [affine(conv2d(outs[i], P, f"{f}layer_blocks.{i}.0", q, 1, 1,
                          bias=False), P, f"{f}layer_blocks.{i}.1")
            for i in range(3)]


def _resize_shape(h: int, w: int, min_side: float, max_side: float = 1333.0):
    """(resized, padded) sizes of torchvision's detection transform: the
    short side to ``min_side`` with the long side capped (the cap shrinks
    with a short side under 800), padded up to a multiple of 32;
    ``min_side <= 0`` keeps the image's scale."""
    scale = 1.0
    if min_side > 0:
        cap = max_side * min(min_side / 800.0, 1.0)
        scale = min(min_side / min(h, w), cap / max(h, w))
    rh, rw = int(h * scale), int(w * scale)
    return (rh, rw), (math.ceil(rh / 32) * 32, math.ceil(rw / 32) * 32)


def sample_image_hw(image_hw, min_side: float):
    """The (h, w) that maps an image pixel to a feature cell: the image's
    own at the reference scale (800), else the padded size in image
    pixels."""
    h, w = image_hw
    if min_side == 800.0:
        return float(h), float(w)
    (rh, rw), (ph, pw) = _resize_shape(h, w, min_side)
    return ph * h / rh, pw * w / rw


def transform_image(image: torch.Tensor, min_side: float = 800.0
                    ) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> (1, 3, Hp, Wp): torchvision's detection
    transform (normalise, resize, pad to 32)."""
    h, w = image.shape[:2]
    (rh, rw), (ph, pw) = _resize_shape(h, w, min_side)
    dt = torch.promote_types(image.dtype, torch.float32)
    mean = torch.tensor(IMAGENET_MEAN, dtype=dt, device=image.device)
    std = torch.tensor(IMAGENET_STD, dtype=dt, device=image.device)
    x = ((image.to(dt) - mean) / std).permute(2, 0, 1)[None]
    if (rh, rw) != (h, w):
        x = F.interpolate(x, size=(rh, rw), mode="bilinear",
                          align_corners=False, antialias=rh < h or rw < w)
    return F.pad(x, (0, pw - rw, 0, ph - rh))


def bilinear_sample(level: torch.Tensor, rc: torch.Tensor, image_hw,
                    eps: float = NORM_EPS) -> torch.Tensor:
    """level (256, Hf, Wf); rc (N, 2) (row, col) in image pixels ->
    (N, 256): bilinear interpolation at the pixel's feature cell, the
    cell coordinate clamped to the grid."""
    _, Hf, Wf = level.shape
    r = torch.clamp(rc[:, 0] / (image_hw[0] / Hf) - eps, 0.0, Hf - 1.0)
    c = torch.clamp(rc[:, 1] / (image_hw[1] / Wf) - eps, 0.0, Wf - 1.0)
    r0, c0 = torch.floor(r).long(), torch.floor(c).long()
    r1, c1 = (r0 + 1).clamp(max=Hf - 1), (c0 + 1).clamp(max=Wf - 1)
    fr, fc = (r - r0)[:, None], (c - c0)[:, None]
    tab = level.permute(1, 2, 0)
    return (tab[r0, c0] * (1 - fr) * (1 - fc) + tab[r1, c0] * fr * (1 - fc)
            + tab[r0, c1] * (1 - fr) * fc + tab[r1, c1] * fr * fc)


def image_features(image: torch.Tensor, vox: Voxels, P: Params, q: Quant,
                   image_hw, min_side: float) -> torch.Tensor:
    """(V, T, 16) per-slot image features: the FPN sampled at each filled
    slot's projection (0 for an empty slot), through the fusion MLP."""
    with torch.no_grad():
        levels = resnet_fpn(transform_image(image, min_side), P, q)
    image_hw = sample_image_hw(image_hw, min_side)
    V, T = vox.filled.shape
    x = torch.zeros((V, T, 768), dtype=levels[0].dtype,
                    device=image.device)
    rc = vox.slots[vox.filled][:, 4:6]
    x[vox.filled] = torch.cat([bilinear_sample(lv[0], rc, image_hw)
                               for lv in levels], dim=-1)
    for name in ("fcn1", "conv1", "fcn2", "conv2", "fcn3"):
        x = dense_relu_norm(x, P, f"head.fusion.{name}.fc", q)
    return x


def vfe(x: torch.Tensor, P: Params, prefix: str, q: Quant) -> torch.Tensor:
    """Slot tensor (V, T, C) -> voxel features (V, 128)."""
    for name in ("svfe.vfe1.fcn.fc", "svfe.vfe2.fcn.fc"):
        h = dense_relu_norm(x, P, prefix + name, q)
        m = h.amax(dim=1, keepdim=True)
        x = torch.cat([h, m.expand_as(h)], dim=-1)
    return dense_relu_norm(x, P, prefix + "fcn.fc", q).amax(dim=1)


def conv3d_relu_norm(x, P, name, q, stride, padding):
    y = F.conv3d(q(x), q(P[name + ".weight"]), P[name + ".bias"], stride,
                 padding)
    return standardize(torch.relu(y), (2, 3, 4))


def middle(feat: torch.Tensor, coords: torch.Tensor, P: Params,
           prefix: str, q: Quant, grid_shape) -> torch.Tensor:
    """Voxel features (V, 128) -> (1, 128, nx, ny): the dense CML."""
    nx, ny, nz = grid_shape
    grid = torch.zeros((1, feat.shape[1], nz, nx, ny), dtype=feat.dtype,
                       device=feat.device)
    grid[0][:, coords[:, 2], coords[:, 0], coords[:, 1]] = feat.T
    x = conv3d_relu_norm(grid, P, prefix + "cml.conv1.conv", q, (2, 1, 1),
                         (1, 1, 1))
    x = conv3d_relu_norm(x, P, prefix + "cml.conv2.conv", q, (1, 1, 1),
                         (0, 1, 1))
    x = conv3d_relu_norm(x, P, prefix + "cml.conv3.conv", q, (2, 1, 1),
                         (1, 1, 1))
    return x.reshape(1, -1, nx, ny)


def rpn(x: torch.Tensor, P: Params, prefix: str, q: Quant
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1, 128, H, W) -> (score (H/2, W/2, A), reg (H/2, W/2, A*7))."""
    p = prefix + "rpn."
    stages = []
    for name, extra in (("blk1", 3), ("blk2", 5), ("blk3", 5)):
        for j in range(extra + 1):
            x = standardize(torch.relu(conv2d(
                x, P, f"{p}{name}.{j}.conv", q, 2 if j == 0 else 1, 1)),
                (2, 3))
        stages.append(x)
    ups = []
    for (name, stride, pad), s in zip((("deconv1", 1, 1), ("deconv2", 2, 0),
                                       ("deconv3", 4, 0)), stages):
        w = P[f"{p}{name}.deconv.weight"]
        y = F.conv_transpose2d(q(s), q(w), P[f"{p}{name}.deconv.bias"],
                               stride, pad)
        ups.append(standardize(torch.relu(y), (2, 3)))
    feat = torch.cat(ups, dim=1)
    score = torch.sigmoid(conv2d(feat, P, p + "cls", q))
    reg = conv2d(feat, P, p + "reg", q)
    return score[0].permute(1, 2, 0), reg[0].permute(1, 2, 0)


def forward_frame(points: torch.Tensor, n: int, image: Optional[torch.Tensor],
                  P: Params, cfg: Dict, q: Quant = identity
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's (score, reg) maps.  points (P, 6) padded cloud (the
    first n real); image (H, W, 3) or None for the LiDAR-only model;
    ``cfg``: velo_range, voxel_shape, max_voxels, samples_per_voxel,
    image_size, image_min_side (800 when absent)."""
    vox = voxelize(points, n, cfg["velo_range"], cfg["voxel_shape"],
                   cfg["max_voxels"], cfg["samples_per_voxel"])
    x = lidar_features(vox)
    prefix = ""
    if image is not None:
        prefix = "backbone."
        x = torch.cat([x, image_features(
            image, vox, P, q, cfg["image_size"],
            cfg.get("image_min_side", 800.0))], dim=-1)
    feat = vfe(x, P, prefix, q)
    y = middle(feat, vox.coords, P, prefix, q, cfg["voxel_shape"])
    return rpn(y, P, prefix, q)


# ---------------------------------------------------------------------------
# anchors and boxes
# ---------------------------------------------------------------------------

def anchors(grid_shape, velo_range, size, device) -> torch.Tensor:
    """(H, W, 2, 7) anchors: centres of the (nx/2, ny/2) BEV cells, z -1,
    the car size, yaws 0 and pi/2."""
    H, W = grid_shape[0] // 2, grid_shape[1] // 2
    x0, y0, _, x1, y1, _ = velo_range
    ls, ws = (x1 - x0) / H, (y1 - y0) / W
    xs = x0 + ls / 2 + ls * np.arange(H, dtype=np.float32)
    ys = y0 + ws / 2 + ws * np.arange(W, dtype=np.float32)
    a = np.zeros((H, W, 2, 7), np.float32)
    a[..., 0] = xs[:, None, None]
    a[..., 1] = ys[None, :, None]
    a[..., 2] = -1.0
    a[..., 3:6] = np.asarray(size, np.float32)
    a[..., 1, 6] = np.float32(np.pi / 2)
    return torch.from_numpy(a).to(device)


def decode(reg: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    """Deltas (..., 7) against anchors -> boxes x y z l w h r."""
    d = torch.sqrt(anc[..., 3] ** 2 + anc[..., 4] ** 2)[..., None]
    return torch.cat([reg[..., 0:2] * d + anc[..., 0:2],
                      reg[..., 2:3] * anc[..., 5:6] + anc[..., 2:3],
                      torch.exp(reg[..., 3:6]) * anc[..., 3:6],
                      reg[..., 6:7] + anc[..., 6:7]], dim=-1)


def encode(gt: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(anc[..., 3] ** 2 + anc[..., 4] ** 2)[..., None]
    return torch.cat([(gt[..., 0:2] - anc[..., 0:2]) / d,
                      (gt[..., 2:3] - anc[..., 2:3]) / anc[..., 5:6],
                      torch.log(gt[..., 3:6].clamp(min=1e-6)
                                / anc[..., 3:6].clamp(min=1e-6)),
                      gt[..., 6:7] - anc[..., 6:7]], dim=-1)
