"""PyTorch port: the KITTI AP evaluator (``eval/ap.py``) against the JAX
package's, on planted, duplicate and false-positive detections, ignored
GTs, empty frames, and 11 or 40 recall points: every dict equal to 1e-12.
"""

import numpy as np
import pytest
import torch

from mvxnet_makise_tpu.eval.ap import (
    average_precision_3d as jax_average_precision_3d,
)
from mvxnet_makise_tpu_torch.eval.ap import (
    average_precision_3d,
    evaluate_frames,
)
from mvxnet_makise_tpu_torch.eval.decode import Detections


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert type(got[k]) is type(want[k]), k
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-12), k


def _gt(rng, n):
    g = np.zeros((n, 7), np.float32)
    g[:, 0] = rng.uniform(5, 60, n)
    g[:, 1] = rng.uniform(-20, 20, n)
    g[:, 2] = rng.uniform(-2, -1, n)
    g[:, 3:6] = [3.9, 1.6, 1.56] * rng.uniform(0.9, 1.1, (n, 3))
    g[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return g


def _scene(rng, n_frames=6):
    """Per frame: GTs, detections (GTs moved a little, some twice, plus
    false positives, shuffled) with their scores, and difficulty flags;
    frame 2 has no GT and frame 3 no detection."""
    gts, dets, diffs = [], [], []
    for f in range(n_frames):
        g = _gt(rng, 0 if f == 2 else int(rng.integers(1, 6)))
        hits = g[rng.random(len(g)) < 0.8]
        hits = hits + rng.normal(0, 0.05, hits.shape).astype(np.float32)
        dup = hits[: len(hits) // 2]
        d = np.concatenate([hits, dup, _gt(rng, int(rng.integers(0, 3)))])
        if f == 3:
            d = d[:0]
        s = rng.uniform(0.05, 1.0, len(d)).astype(np.float32)
        order = rng.permutation(len(d))
        gts.append(g)
        dets.append((d[order], s[order]))
        diffs.append(rng.integers(-1, 3, len(g)).astype(np.int32))
    return gts, dets, diffs


@pytest.mark.parametrize("recall_points,iou", [(40, 0.7), (11, 0.5)])
def test_average_precision_matches_jax(rng, recall_points, iou):
    gts, dets, diffs = _scene(rng)
    got = average_precision_3d(dets, gts, iou, recall_points)
    want = jax_average_precision_3d(dets, gts, iou, recall_points)
    _same(got, want)
    assert 0 < got["ap"] < 1 and got["num_gt"] > 0
    for dmax in (0, 1, 2):
        ignored = [~((d >= 0) & (d <= dmax)) for d in diffs]
        _same(average_precision_3d(dets, gts, iou, recall_points, ignored),
              jax_average_precision_3d(dets, gts, iou, recall_points,
                                       ignored))


def test_planted_and_empty_cases_match_jax(rng):
    g = _gt(rng, 3)
    empty = (np.zeros((0, 7), np.float32), np.zeros(0, np.float32))
    cases = [
        ([(g, np.array([0.9, 0.8, 0.7], np.float32))], [g], None),
        ([empty], [g], None),
        ([(g, np.array([0.9, 0.8, 0.7], np.float32))],
         [np.zeros((0, 7), np.float32)], None),
        ([(np.concatenate([g, g]), np.linspace(1, 0.1, 6, dtype=np.float32))],
         [g], [np.array([False, True, False])]),
        ([(g, np.array([0.9, 0.8, 0.7], np.float32))], [g],
         [np.ones(3, bool)]),
    ]
    for dets, gts, ignored in cases:
        _same(average_precision_3d(dets, gts, gt_ignored=ignored),
              jax_average_precision_3d(dets, gts, gt_ignored=ignored))
    assert average_precision_3d(*cases[0][:2])["ap"] == pytest.approx(1.0)


def test_evaluate_frames_takes_the_decoders_detections(rng):
    gts, dets, _ = _scene(rng, 3)
    G = max(len(g) for g in gts)
    gt_boxes = np.zeros((3, G, 7), np.float32)
    gt_mask = np.zeros((3, G), bool)
    decoded = []
    for b, (g, (d, s)) in enumerate(zip(gts, dets)):
        gt_boxes[b, :len(g)] = g
        gt_mask[b, :len(g)] = True
        pad = 4
        decoded.append(Detections(
            boxes=torch.from_numpy(np.concatenate(
                [d, np.zeros((pad, 7), np.float32)])),
            scores=torch.from_numpy(np.concatenate(
                [s, np.zeros(pad, np.float32)])),
            valid=torch.from_numpy(np.arange(len(d) + pad) < len(d)),
            classes=torch.zeros(len(d) + pad, dtype=torch.int32)))
    _same(evaluate_frames(decoded, gt_boxes, gt_mask),
          jax_average_precision_3d(dets, gts))
