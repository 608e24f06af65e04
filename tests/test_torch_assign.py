"""PyTorch port: dense anchor-target assignment against the JAX package.

The same GT boxes (numpy, from a seed) go through JAX's
``assign_anchor_targets`` and the port's, on the tiny grid of the other
port tests (a 16 x 20 anchor grid).  The outputs are decisions (IoU
against thresholds, then a max), so they must agree exactly: float64 on
both sides (JAX under ``jax.enable_x64``), and one float32 case.
Cases: one class, three classes with per-class thresholds, the
best-anchor fallback, and a frame without GT.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.ops.assign import (
    assign_anchor_targets as jax_assign,
)
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.ops.assign import assign_anchor_targets

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), max_boxes=6, assign_window=6)
CFG = Config(**KW)
MULTI = Config(target_classes=("Car", "Pedestrian", "Cyclist"), **KW)


def _boxes(seed, cfg, yaws=None):
    """GT boxes over the BEV range (one straddling the grid's edge), sized
    like their class's anchors; the last row is masked padding."""
    rng = np.random.default_rng(seed)
    G = cfg.max_boxes
    cls = rng.integers(0, cfg.num_classes, G).astype(np.int32)
    sizes = np.asarray(cfg.anchor_sizes, np.float32)[cls]
    gt = np.zeros((G, 7), np.float32)
    gt[:, 0] = rng.uniform(0.5, 12.3, G)
    gt[:, 1] = rng.uniform(-7.5, 7.5, G)
    gt[0, :2] = (0.3, 7.8)                       # window leaves the grid
    gt[:, 2] = -1.0
    gt[:, 3:6] = sizes * rng.uniform(0.9, 1.1, (G, 3))
    # axis-aligned yaws reach the positive threshold
    gt[:, 6] = (rng.choice([0.0, np.pi / 2, 0.1], G) if yaws is None
                else yaws)
    mask = np.ones(G, bool)
    mask[-1] = False
    gt[-1] = 99.0                                # garbage in the padding
    return gt, mask, cls


def _run(cfg, gt, mask, cls, dtype, **kw):
    args = dict(grid_hw=cfg.feature_map_shape, velo_range=cfg.velo_range,
                box_size=cfg.anchor_sizes,
                neg_threshold=cfg.class_neg_thresholds,
                pos_threshold=cfg.class_pos_thresholds,
                window=cfg.assign_window, **kw)
    with jax.enable_x64(dtype == np.float64):
        want = jax_assign(jnp.asarray(gt.astype(dtype)), jnp.asarray(mask),
                          gt_classes=jnp.asarray(cls), **args)
        want = [np.asarray(w) for w in want]
    got = assign_anchor_targets(torch.from_numpy(gt.astype(dtype)),
                                torch.from_numpy(mask),
                                gt_classes=torch.from_numpy(cls), **args)
    return got, want


@pytest.mark.parametrize("case", [
    dict(cfg=CFG, seed=0, dtype=np.float64),
    dict(cfg=CFG, seed=1, dtype=np.float32),
    dict(cfg=MULTI, seed=2, dtype=np.float64),
])
def test_assign_matches_jax(case):
    cfg = case["cfg"]
    gt, mask, cls = _boxes(case["seed"], cfg)
    got, want = _run(cfg, gt, mask, cls, case["dtype"])
    H, W = cfg.feature_map_shape
    assert got.pos.shape == (H, W, cfg.anchors_per_loc)
    assert got.gt_index.dtype == torch.int32
    for name, g, w in zip(("pos", "ignore", "gt_index"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.pos.sum() > 0
    assert (got.ignore.sum() > got.pos.sum())
    # the masked padding row matches nothing
    assert not (got.gt_index == cfg.max_boxes - 1).any()


def test_assign_fallback_matches_jax():
    """Boxes at 45 degrees reach no anchor's positive threshold; the
    fallback makes each GT's best anchor positive."""
    gt, mask, cls = _boxes(3, CFG, yaws=np.pi / 4)
    plain, _ = _run(CFG, gt, mask, cls, np.float64)
    got, want = _run(CFG, gt, mask, cls, np.float64,
                     best_anchor_fallback=True)
    for name, g, w in zip(("pos", "ignore", "gt_index"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got.pos.sum()) > int(plain.pos.sum())


def test_assign_without_gt_matches_jax():
    gt, mask, cls = _boxes(4, CFG)
    got, want = _run(CFG, gt, np.zeros_like(mask), cls, np.float64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert not got.pos.any() and not got.ignore.any()
    assert (got.gt_index == -1).all()


def test_assign_refuses_a_narrow_window():
    gt, mask, cls = _boxes(0, CFG)
    with pytest.raises(ValueError, match="under-covers"):
        assign_anchor_targets(
            torch.from_numpy(gt), torch.from_numpy(mask),
            grid_hw=CFG.feature_map_shape, velo_range=CFG.velo_range,
            box_size=CFG.anchor_sizes[0], neg_threshold=0.45,
            pos_threshold=0.6, window=1)
