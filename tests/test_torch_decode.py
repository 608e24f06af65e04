"""PyTorch port: the inference tail against the JAX package.

Box decoding, rotated BEV IoU, greedy rotated NMS and
``decode_predictions``.  Geometry compares in float64 (1e-9); NMS and
decoding must pick the same boxes in the same order, including among
tied scores (the JAX side's ``lax.top_k`` keeps the lower index first,
the port sorts stably).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.eval.decode import (
    decode_predictions as jax_decode_predictions,
)
from mvxnet_makise_tpu.geometry import boxes as jax_boxes
from mvxnet_makise_tpu.ops.nms import rotated_nms_bev as jax_nms
from mvxnet_makise_tpu_torch.eval.decode import decode_predictions
from mvxnet_makise_tpu_torch.geometry import boxes
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.ops.nms import rotated_nms_bev

TOL64 = dict(rtol=1e-9, atol=1e-9)


def _boxes(rng, n):
    """Clustered boxes (many overlaps), plus exact duplicates, a rotated
    copy and an edge-touching neighbour of the first box."""
    b = np.zeros((n, 7))
    centers = rng.uniform([0, -5], [10, 5], (max(n // 6, 1), 2))
    b[:, :2] = centers[rng.integers(0, len(centers), n)] + \
        rng.normal(0, 0.8, (n, 2))
    b[:, 2] = rng.uniform(-2, -1, n)
    b[:, 3:6] = rng.uniform([3, 1.4, 1.4], [4.5, 1.9, 1.8], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[1] = b[0]
    b[2] = b[0]
    b[2, 6] += np.pi / 2
    b[3] = b[0]
    b[3, 6] = 0.0
    b[4] = b[3]
    b[4, 0] += b[3, 3]           # shares an edge with box 3
    return b


def test_decode_boxes_and_corners_match_jax():
    rng = np.random.default_rng(0)
    anchors = create_anchors((6, 8), (0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
                             (3.9, 1.6, 1.56)).astype(np.float64)
    deltas = rng.normal(0, 0.3, anchors.shape)
    with jax.enable_x64(True):
        want = jax_boxes.decode_boxes(jnp.asarray(deltas),
                                      jnp.asarray(anchors))
        want_c = jax_boxes.boxes3d_to_bev_corners(want)
    got = boxes.decode_boxes(torch.from_numpy(deltas),
                             torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL64)
    np.testing.assert_allclose(boxes.boxes3d_to_bev_corners(got).numpy(),
                               np.asarray(want_c), **TOL64)


def test_rotated_iou_matches_jax():
    rng = np.random.default_rng(1)
    b = _boxes(rng, 60)
    with jax.enable_x64(True):
        want = np.asarray(jax_boxes.rotated_iou_bev(jnp.asarray(b),
                                                    jnp.asarray(b)))
    got = boxes.rotated_iou_bev(torch.from_numpy(b), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL64)
    assert got[0, 1] == pytest.approx(1.0)       # duplicate
    assert got[3, 4] == 0.0                       # edge contact only
    assert (want > 0.1).sum() > 100               # the boxes do overlap


@pytest.mark.parametrize("pre,post", [(256, 64), (40, 8)])
def test_rotated_nms_matches_jax(pre, post):
    rng = np.random.default_rng(2)
    b = _boxes(rng, 300)
    # coarse scores: many ties, which both sides break by lower index
    s = np.round(rng.uniform(0, 1, 300), 2)
    kw = dict(iou_threshold=0.1, score_threshold=0.3, pre_max_size=pre,
              post_max_size=post)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jax_nms(jnp.asarray(b),
                                               jnp.asarray(s), **kw)]
    got = [a.numpy() for a in rotated_nms_bev(torch.from_numpy(b),
                                              torch.from_numpy(s), **kw)]
    assert want[2].sum() > 3
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("classes", [("Car",), ("Car", "Pedestrian")])
def test_decode_predictions_matches_jax(classes):
    """float32 maps as the detectors hand them over; scores rounded to
    produce ties."""
    rng = np.random.default_rng(3)
    sizes = [(3.9, 1.6, 1.56), (0.8, 0.6, 1.73)][:len(classes)]
    anchors = create_anchors((16, 20), (0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
                             sizes)
    A = anchors.shape[2]
    score = np.round(rng.uniform(0, 1, (16, 20, A)), 3).astype(np.float32)
    reg = rng.normal(0, 0.2, (16, 20, A * 7)).astype(np.float32)
    want = jax_decode_predictions(jnp.asarray(score), jnp.asarray(reg),
                                  jnp.asarray(anchors))
    got = decode_predictions(torch.from_numpy(score), torch.from_numpy(reg),
                             torch.from_numpy(anchors))
    v = np.asarray(want.valid)
    assert v.sum() > 5
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy()[v],
                               np.asarray(want.boxes)[v], rtol=1e-6,
                               atol=1e-5)
