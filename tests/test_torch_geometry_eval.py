"""PyTorch port: the geometry the data path and the evaluator use, against
the JAX package.

Torch boxes (``geometry/boxes.py``): 3D corners, polygon areas, corner-quad
BEV IoU, rotated 3D IoU, camera <-> LiDAR label conversion and the 2D
intersection, each within 1e-12 of JAX in float64 (JAX under
``jax.enable_x64``); the numpy conversions bit-equal.  The numpy box
geometry (``geometry/boxes_np.py``), the calib inverses and the range /
frustum masks (``ops/voxelize.py``) equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvxnet_makise_tpu.geometry import boxes as jb
from mvxnet_makise_tpu.geometry import boxes_np as jbn
from mvxnet_makise_tpu.geometry import calib as jcal
from mvxnet_makise_tpu.ops.voxelize import crop_to_range_mask as j_range_mask
from mvxnet_makise_tpu.ops.voxelize import frustum_mask as j_frustum_mask
from mvxnet_makise_tpu_torch.data.synthetic import toy_calib
from mvxnet_makise_tpu_torch.geometry import boxes as tb
from mvxnet_makise_tpu_torch.geometry import boxes_np as tbn
from mvxnet_makise_tpu_torch.geometry import calib as tcal
from mvxnet_makise_tpu_torch.ops.voxelize import (
    crop_to_range_mask,
    frustum_mask,
)


def _boxes(rng, n, spread=6.0):
    b = np.zeros((n, 7))
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _near(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def test_corners_and_polygon_area_match_jax(x64, rng):
    b = _boxes(rng, 9)
    _near(tb.boxes3d_to_corners3d(torch.from_numpy(b)),
          jb.boxes3d_to_corners3d(jnp.asarray(b)))
    verts = rng.normal(size=(8, 2))
    for count in (3, 5, 8):
        _near(tb.polygon_area(torch.from_numpy(verts), count),
              jb.polygon_area(jnp.asarray(verts), jnp.asarray(count)))


def test_iou_matches_jax(x64, rng):
    """Random pairs, identical boxes, shared corners, touching edges and
    disjoint boxes."""
    a, b = _boxes(rng, 12, 3.0), _boxes(rng, 10, 3.0)
    b[0] = a[0]
    b[1] = a[1] + [a[1, 3], 0, 0, 0, 0, 0, 0]
    b[1, 6] = a[1, 6] = 0.0
    b[2] = a[2] + [40, 0, 0, 0, 0, 0, 0]
    ta, tbb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jbb = jnp.asarray(a), jnp.asarray(b)
    _near(tb.rotated_iou_3d(ta, tbb), jb.rotated_iou_3d(ja, jbb))
    qa, qb = tb.boxes3d_to_bev_corners(ta), tb.boxes3d_to_bev_corners(tbb)
    _near(tb.corners_iou_bev(qa, qb),
          jb.corners_iou_bev(jnp.asarray(qa.numpy()),
                             jnp.asarray(qb.numpy())))
    iou = tb.rotated_iou_3d(ta, tbb).numpy()
    assert iou[0, 0] == pytest.approx(1.0, abs=1e-12)
    assert iou[2, 2] == 0.0


def test_rotated_iou_3d_float32_matches_jax_default(rng):
    """The evaluator's dtype: float32 on both sides."""
    a = _boxes(rng, 6, 2.0).astype(np.float32)
    b = a + rng.normal(0, 0.2, a.shape).astype(np.float32)
    got = tb.rotated_iou_3d(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    _near(got, jb.rotated_iou_3d(jnp.asarray(a), jnp.asarray(b)), 1e-6)


def test_label_conversions_match_jax(x64, rng):
    c2v = np.linalg.inv(toy_calib().velo_to_cam).astype(np.float32)
    cam = rng.normal(size=(7, 7)).astype(np.float32)
    np.testing.assert_array_equal(tb.boxes_cam_to_lidar(cam, c2v),
                                  jb.boxes_cam_to_lidar(cam, c2v))
    lidar = _boxes(rng, 7).astype(np.float32)
    np.testing.assert_array_equal(tb.boxes_lidar_to_cam(lidar, c2v),
                                  jb.boxes_lidar_to_cam(lidar, c2v))
    cam64 = cam.astype(np.float64)
    got = tb.boxes_cam_to_lidar(torch.from_numpy(cam64), c2v)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    _near(got, jb.boxes_cam_to_lidar(jnp.asarray(cam64), c2v))
    _near(tb.boxes_lidar_to_cam(got, np.linalg.inv(c2v)),
          jb.boxes_lidar_to_cam(jb.boxes_cam_to_lidar(jnp.asarray(cam64),
                                                      c2v),
                                np.linalg.inv(c2v)))
    b1 = rng.uniform(0, 50, (5, 4))
    b1[:, 2:] += b1[:, :2]
    b2 = rng.uniform(0, 50, (4, 4))
    b2[:, 2:] += b2[:, :2]
    np.testing.assert_array_equal(tb.aligned_bbox_intersection(b1, b2),
                                  jb.aligned_bbox_intersection(b1, b2))
    _near(tb.aligned_bbox_intersection(torch.from_numpy(b1),
                                       torch.from_numpy(b2)),
          jb.aligned_bbox_intersection(jnp.asarray(b1), jnp.asarray(b2)))


def test_numpy_box_geometry_matches_jax(rng):
    a = _boxes(rng, 6, 2.0).astype(np.float32)
    b = _boxes(rng, 5, 2.0).astype(np.float32)
    np.testing.assert_array_equal(tbn.bev_corners(a), jbn.bev_corners(a))
    np.testing.assert_array_equal(tbn.iou_bev(a, b), jbn.iou_bev(a, b))
    qa, qb = tbn.bev_corners(a), tbn.bev_corners(b)
    np.testing.assert_array_equal(tbn.iou_bev_corners(qa, qb),
                                  jbn.iou_bev_corners(qa, qb))
    pts = rng.uniform(-4, 4, (500, 4)).astype(np.float32)
    for box in a:
        np.testing.assert_array_equal(tbn.points_in_box3d(pts, box),
                                      jbn.points_in_box3d(pts, box))
    np.testing.assert_array_equal(tbn.intersection_2d(a[:, :4], b[:, :4]),
                                  jbn.intersection_2d(a[:, :4], b[:, :4]))


def test_calib_inverses_match_jax(rng):
    c = toy_calib((64, 96))
    jc = jcal.Calib(c.velo_to_cam, c.P2, c.R0)
    pts = rng.uniform(-10, 10, (50, 4)).astype(np.float32)
    np.testing.assert_array_equal(tcal.lidar_depths(pts, c),
                                  jcal.lidar_depths(pts, jc))
    np.testing.assert_array_equal(tcal.rect_to_lidar(pts, c),
                                  jcal.rect_to_lidar(pts, jc))


def test_crop_masks_match_jax(rng):
    c = toy_calib((64, 96))
    vr = (0.0, -8.0, -3.0, 12.8, 8.0, 1.0)
    pts = rng.uniform([-2, -10, -4, 0], [15, 10, 2, 1],
                      (4000, 4)).astype(np.float32)
    rect = (c.R0 @ c.velo_to_cam).astype(np.float32)
    proj = c.P2 @ rect
    want = np.asarray(j_range_mask(jnp.asarray(pts), vr)
                      & j_frustum_mask(jnp.asarray(pts), jnp.asarray(proj),
                                       jnp.asarray(rect), (64, 96)))
    t = torch.from_numpy(pts)
    got = (crop_to_range_mask(t, vr)
           & frustum_mask(t, torch.from_numpy(proj), torch.from_numpy(rect),
                          (64, 96))).numpy()
    assert 100 < want.sum() < len(pts)
    np.testing.assert_array_equal(got, want)
