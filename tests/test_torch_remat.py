"""PyTorch port: ``remat`` and the repository's shipped configurations.

``remat=True`` checkpoints the CML (``torch.utils.checkpoint``, as JAX's
``nn.remat``): the backward pass recomputes it instead of keeping its
activations.  That changes the graph and not the result: on the CPU the
loss and every gradient are bit-equal with and without it, in float32 and
under ``use_bf16``, in both CML modes, while CML conv1 runs twice per step
instead of once.  In float64 the port's remat step equals JAX's remat step
to 1e-8 (loss and gradients), JAX compiled without XLA's algebraic
simplifier as ``tests/test_torch_train.py`` explains.

Every ``configs/*.yaml`` loads to the same ``Config`` in both packages,
and builds and runs in the port with the grid, clouds and images cut to
the tiny test sizes (the LiDAR-only config as the LiDAR-only model).
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.config import load_config as jax_load_config
from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
from mvxnet_makise_tpu.train.loss import voxel_loss as jax_voxel_loss
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.step import _assign_batch as jax_assign_batch
from mvxnet_makise_tpu.train.step import _model_inputs
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config, load_config
from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
from mvxnet_makise_tpu_torch.data.synthetic import (
    synthetic_frame,
    synthetic_frame_multiclass,
)
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.weights import (
    load_jax_params,
    mvxnet_state,
)
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.train.loop import (
    collate,
    preprocess_train_frame,
)
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    forward,
    frames_to_batch,
    make_train_step,
)
from _jax_ref import jit_dividing
from test_torch_train import _random_params

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0, batch_size=2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _tensors(cfg, seed=0):
    """A collated batch of two synthetic frames with axis-aligned cars
    (positive anchors), and a voxelizer shuffle."""
    rng = np.random.default_rng(seed)
    arrays = []
    for i, n in enumerate((900, 1500)):
        if cfg.num_classes > 1:
            pts, calib, image, boxes = synthetic_frame_multiclass(rng, cfg)
        else:
            pts, calib, image, cars = synthetic_frame(
                rng, cfg, num_cars=3, num_points=n, yaw_range=(0.0, 0.0))
            boxes = {"Car": cars}
        arrays.append(preprocess_train_frame(
            KittiFrame(f"f{i}", pts, image, calib, boxes), cfg, None,
            np.random.default_rng(i)))
    g = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(cfg.max_points, generator=g)
                        for _ in range(2)])
    return collate(arrays, torch.device("cpu")), perm


def _step(cfg, weights, tensors, perm, with_images=True):
    """One train step from ``weights``; returns (metrics, gradients, the
    number of CML conv1 forwards)."""
    model = build_model(cfg, seed=None, device="cpu",
                        with_images=with_images)
    model = model.to(next(iter(weights.values())).dtype)
    model.load_state_dict(weights)
    model.train()
    conv1 = (model.backbone if with_images else model).cml.conv1
    calls = []
    conv1.register_forward_hook(lambda *_: calls.append(1))
    state = TrainState.create(cfg, model)
    pts, nums, imgs, gts, gms, gcs = tensors
    batch = frames_to_batch(pts, nums, imgs, cfg, gt_boxes=gts,
                            gt_mask=gms, gt_classes=gcs, perm=perm)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes))
    metrics = make_train_step(cfg, anchors, with_images)(state, batch)
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    return metrics, grads, len(calls)


@pytest.mark.parametrize("mode,bf16,with_images", [
    ("column", False, True), ("column", True, True),
    ("dense3d", False, True), ("column", True, False)])
def test_remat_is_bit_equal_to_no_remat(mode, bf16, with_images):
    cfg = Config(**KW, cml_mode=mode, use_bf16=bf16,
                 scatter_backend="pallas" if mode == "dense3d" else "auto")
    weights = build_model(cfg, seed=3, device="cpu",
                          with_images=with_images).state_dict()
    tensors, perm = _tensors(cfg)
    plain = _step(cfg, weights, tensors, perm, with_images)
    remat = _step(cfg.replace(remat=True), weights, tensors, perm,
                  with_images)
    assert float(plain[0]["num_pos"]) > 0
    assert (plain[2], remat[2]) == (1, 2)
    for k in plain[0]:
        assert torch.equal(plain[0][k], remat[0][k]), k
    assert plain[1].keys() == remat[1].keys() and len(plain[1]) > 10
    for k, g in plain[1].items():
        assert torch.equal(g, remat[1][k]), k


def test_remat_step_matches_jax_remat_step():
    """float64: the port's remat step against JAX's remat step."""
    cfg, jcfg = Config(**KW, remat=True), JaxConfig(**KW, remat=True)
    model = JaxMVXNetPM(
        grid_shape=jcfg.voxel_shape, image_size=jcfg.image_size,
        anchors_per_loc=jcfg.anchors_per_loc,
        image_min_side=jcfg.image_min_side,
        samples_per_voxel=jcfg.samples_per_voxel, cml_mode="column",
        remat=True)
    params = _random_params(model, jcfg, np.random.default_rng(0))
    tensors, _ = _tensors(cfg, seed=1)
    pts, nums, imgs, gts, gms, gcs = (t.numpy() for t in tensors)
    key = jax.random.key(5)
    perm = np.stack([np.asarray(jax.random.permutation(k, cfg.max_points))
                     for k in jax.random.split(key, 2)])
    anchors = create_anchors(cfg.feature_map_shape, cfg.velo_range,
                             cfg.anchor_sizes).astype(np.float64)
    apply_fn = make_apply(model, jcfg)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)

        def loss_fn(p, batch):
            targets = jax_assign_batch(batch, jcfg)
            score, reg = apply_fn(p, *_model_inputs(batch, True))
            losses, _ = jax.vmap(lambda s, r, t, g: jax_voxel_loss(
                s, r, t, g, jnp.asarray(anchors),
                pos_weight=jcfg.pos_loss_weight,
                neg_weight=jcfg.neg_loss_weight, eps=jcfg.eps,
                mode=jcfg.cls_loss_mode, focal_gamma=jcfg.focal_gamma,
                focal_alpha=jcfg.focal_alpha))(score, reg, targets,
                                               batch.gt_boxes)
            return jnp.mean(losses)

        def step(p, pts, nums, imgs, gts, gms, gcs):
            batch = jax_batch(pts, nums, imgs, gts, gms, jcfg,
                              shuffle_key=key, gt_classes=gcs)
            return jax.value_and_grad(loss_fn)(p, batch)

        loss, grads = jit_dividing(step)(
            p64, jnp.asarray(pts, jnp.float64), jnp.asarray(nums),
            jnp.asarray(imgs, jnp.float64), jnp.asarray(gts, jnp.float64),
            jnp.asarray(gms), jnp.asarray(gcs))
        want = mvxnet_state(jax.device_get(grads)["params"])
    port = build_model(cfg, seed=None, device="cpu")
    load_jax_params(port, params)
    weights = port.double().state_dict()
    t64 = [t.double() if t.is_floating_point() else t for t in tensors]
    metrics, got, calls = _step(cfg, weights, t64, torch.from_numpy(perm))
    assert calls == 2
    np.testing.assert_allclose(float(metrics["total_loss"]), float(loss),
                               rtol=1e-8)
    assert got.keys() == {k for k in want if "extractor" not in k}
    for k, g in got.items():
        w = np.asarray(want[k])
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-8 * max(float(np.abs(w).max()), 1e-30), k


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_shipped_config_loads_as_in_jax_and_runs(path):
    """The same Config from both packages' ``load_config``; then the
    port's model at tiny widths (the config's own RPN trunk, classes,
    bf16 and remat), one forward in its compute dtype."""
    want, got = jax_load_config(path), load_config(path)
    for f in ("use_bf16", "remat", "fusion_mode", "target_classes",
              "batch_size", "rpn_channels", "max_points", "image_min_side"):
        assert getattr(got, f) == getattr(want, f), f
    assert {f.name: getattr(got, f.name) for f in got.__dataclass_fields__
            .values()} == {f.name: getattr(want, f.name) for f in
                           want.__dataclass_fields__.values()}
    with_images = "lidar_only" not in os.path.basename(path)
    tiny = dict(KW, assign_window=8, max_points=1024,
                image_min_side=0 if got.image_min_side == 800 else 40)
    cfg = load_config(path, **tiny)
    model = build_model(cfg, seed=0, device="cpu", with_images=with_images)
    tensors, _ = _tensors(cfg)
    batch = frames_to_batch(*tensors[:3], cfg)
    with torch.no_grad():
        score, reg = forward(model, batch, cfg, with_images)
    dtype = (torch.bfloat16 if cfg.use_bf16 and with_images
             else torch.float32)
    assert score.dtype == reg.dtype == dtype
    assert score.shape == (2, 16, 20, cfg.anchors_per_loc)
    assert bool(torch.isfinite(score.float()).all())
