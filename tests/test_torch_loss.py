"""PyTorch port: the detection loss against the JAX package.

One frame's score and regression maps (numpy, from a seed), the targets
JAX assigns for random GT boxes, and the anchors go through JAX's
``voxel_loss`` and the port's, in float64 on both sides (JAX under
``jax.enable_x64``): the loss, its metrics and its gradients with respect
to both maps agree to 1e-10 relative (summation order only).  Modes
"reference" and "focal", with and without GT boxes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.geometry.boxes import encode_boxes as jax_encode
from mvxnet_makise_tpu.ops.assign import AnchorTargets as JaxTargets
from mvxnet_makise_tpu.ops.assign import (
    assign_anchor_targets as jax_assign,
)
from mvxnet_makise_tpu.train.loss import smooth_l1 as jax_smooth_l1
from mvxnet_makise_tpu.train.loss import voxel_loss as jax_voxel_loss
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.geometry.boxes import encode_boxes
from mvxnet_makise_tpu_torch.ops.assign import AnchorTargets, create_anchors
from mvxnet_makise_tpu_torch.train.loss import smooth_l1, voxel_loss

CFG = Config(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
             voxel_shape=(32, 40, 10), max_boxes=4, assign_window=6)
TOL = dict(rtol=1e-10, atol=1e-12)


def _frame(seed, with_gt=True):
    rng = np.random.default_rng(seed)
    H, W = CFG.feature_map_shape
    A = CFG.anchors_per_loc
    score = 1 / (1 + np.exp(-rng.normal(0, 2, (H, W, A))))
    reg = rng.normal(0, 0.5, (H, W, A * 7))
    gt = np.zeros((CFG.max_boxes, 7))
    gt[:, 0] = rng.uniform(2, 11, CFG.max_boxes)
    gt[:, 1] = rng.uniform(-6, 6, CFG.max_boxes)
    gt[:, 2] = -1.0
    gt[:, 3:6] = CFG.car_size
    gt[:, 6] = rng.choice([0.0, np.pi / 2], CFG.max_boxes)
    mask = np.array([True, True, True, False]) & with_gt
    with jax.enable_x64(True):
        targets = jax_assign(
            jnp.asarray(gt), jnp.asarray(mask), grid_hw=(H, W),
            velo_range=CFG.velo_range, box_size=CFG.anchor_sizes,
            neg_threshold=CFG.class_neg_thresholds,
            pos_threshold=CFG.class_pos_thresholds,
            window=CFG.assign_window)
    anchors = create_anchors((H, W), CFG.velo_range,
                             CFG.anchor_sizes).astype(np.float64)
    return score, reg, [np.array(t) for t in targets], gt, anchors


@pytest.mark.parametrize("mode", ["reference", "focal"])
@pytest.mark.parametrize("with_gt", [True, False])
def test_voxel_loss_and_gradients_match_jax(mode, with_gt):
    score, reg, targets, gt, anchors = _frame(0, with_gt)
    kw = dict(pos_weight=CFG.pos_loss_weight,
              neg_weight=CFG.neg_loss_weight, eps=CFG.eps, mode=mode,
              focal_gamma=CFG.focal_gamma, focal_alpha=CFG.focal_alpha)
    with jax.enable_x64(True):
        jt = [jnp.asarray(t) for t in targets]

        def f(s, r):
            return jax_voxel_loss(s, r, JaxTargets(*jt), jnp.asarray(gt),
                                  jnp.asarray(anchors), **kw)

        (want, want_m), (want_gs, want_gr) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(score),
                                             jnp.asarray(reg))
    s = torch.from_numpy(score).requires_grad_()
    r = torch.from_numpy(reg).requires_grad_()
    loss, metrics = voxel_loss(
        s, r, AnchorTargets(*map(torch.from_numpy, targets)),
        torch.from_numpy(gt), torch.from_numpy(anchors), **kw)
    loss.backward()
    assert (int(metrics["num_pos"]) > 0) == with_gt
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for k in ("cls_loss", "reg_loss", "num_pos", "num_not_neg"):
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_gs), **TOL)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(want_gr), **TOL)
    if not with_gt:
        assert float(metrics["reg_loss"]) == 0.0
        assert not r.grad.any()


def test_encode_and_smooth_l1_match_jax():
    rng = np.random.default_rng(1)
    gt = rng.uniform(0.5, 4, (50, 7))
    anchors = rng.uniform(0.5, 4, (50, 7))
    gt[0, 3] = 0.0                       # a degenerate size is clamped
    with jax.enable_x64(True):
        want = np.asarray(jax_encode(jnp.asarray(gt), jnp.asarray(anchors)))
        want_l1 = np.asarray(jax_smooth_l1(jnp.asarray(want),
                                           jnp.zeros_like(want)))
    got = encode_boxes(torch.from_numpy(gt), torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        smooth_l1(got, torch.zeros_like(got)).numpy(), want_l1, **TOL)
