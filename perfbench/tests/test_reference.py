"""The plain reference agrees with the program at a tiny size on the CPU,
in float64, fed the program's own assembled frames (so the shuffle is
out of the question here: test_host holds it)."""

import numpy as np
import pytest
import torch

from perfbench import generate
from perfbench.reference import host, model as R

RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)


@pytest.mark.parametrize("with_images", [True, False])
def test_maps_agree_in_float64(with_images):
    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.geometry.calib import Calib
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.serve import Detector

    cfg = Config(voxel_shape=(32, 40, 10), image_size=(64, 96),
                 image_min_side=0, max_points=1024, max_voxels=256,
                 samples_per_voxel=8, assign_window=6)
    P = {k: v.double() for k, v in R.make_params(
        R.param_spec(with_images), 5, "cpu").items()}
    model = build_model(cfg, seed=None, device="cpu",
                        with_images=with_images).double()
    model.load_state_dict(P, strict=True)
    det = Detector(cfg, model, with_images=with_images)
    mix = {"edge_margin_px": 0.01, "edge_margin_m": 0.001,
           "view_points": [800, 1200], "out_of_view_points": [2000, 3000],
           "cars_in_view": 8, "cars_out_of_view": 2, "car_share": 0.25,
           "wall_share": 0.15, "images": True, "pool": 2}
    pool = generate.make_pool(123, mix, RANGE, cfg.image_size, cfg.car_size)
    frames = [(f.scan, Calib(velo_to_cam=f.camera.velo_to_cam,
                             P2=f.camera.P2, R0=f.camera.R0),
               f.image if with_images else None) for f in pool]
    pts, nums, imgs = det.assemble(frames)
    score, reg = det.maps(pts, nums, imgs)
    rc = dict(velo_range=RANGE, voxel_shape=cfg.voxel_shape,
              max_voxels=cfg.max_voxels,
              samples_per_voxel=cfg.samples_per_voxel,
              image_size=cfg.image_size, image_min_side=0)
    for b, f in enumerate(pool):
        rp, rn = host.assemble(f.scan, f.camera.rect, f.camera.proj, RANGE,
                               cfg.image_size, cfg.max_points)
        assert rn == nums[b]
        image = torch.from_numpy(f.image).double() if with_images else None
        s, r = R.forward_frame(torch.from_numpy(pts[b]).double(), rn, image,
                               P, rc)
        # the program's detection transform normalises the image in
        # float32 (3.7e-7 apart from float64), which the untrained model
        # carries to ~1e-5 in its maps; the LiDAR branch alone is float64
        tol = 1e-3 if with_images else 1e-10
        assert (score[b] - s).abs().max() < tol
        assert (reg[b] - r.reshape(reg[b].shape)).abs().max() < 10 * tol


def test_iou_of_known_boxes():
    from perfbench.reference.train import iou_bev

    a = torch.tensor([[0.0, 0, 0, 2, 2, 1, 0]])
    b = torch.tensor([[1.0, 0, 0, 2, 2, 1, 0], [0.0, 0, 0, 2, 2, 1,
                                                 np.pi / 4]])
    iou = iou_bev(a, b)[0]
    assert abs(float(iou[0]) - 2 / 6) < 1e-12
    # a square and itself turned 45 degrees: the octagon of area
    # 8 (sqrt 2 - 1)
    inter = 8 * (np.sqrt(2) - 1)
    assert abs(float(iou[1]) - inter / (8 - inter)) < 1e-12


def test_nms_of_known_boxes():
    from perfbench.reference.nms import nms

    boxes = torch.tensor([[0.0, 0, 0, 4, 2, 1, 0], [0.5, 0, 0, 4, 2, 1, 0],
                          [10.0, 0, 0, 4, 2, 1, 0], [20.0, 0, 0, 4, 2, 1, 0]])
    scores = torch.tensor([0.5, 0.9, 0.6, 0.2])
    post = {"score_threshold": 0.3, "nms_iou_threshold": 0.1,
            "pre_max_size": 256, "post_max_size": 64}
    # the second box suppresses the first; the fourth is under the threshold
    assert nms(boxes, scores, post).tolist() == [1, 2]
    assert nms(boxes, scores, {**post, "post_max_size": 1}).tolist() == [1]


def test_nms_agrees_with_the_program():
    from mvxnet_makise_tpu_torch.ops.nms import rotated_nms_bev_batch
    from perfbench.reference.nms import nms

    gen = torch.Generator().manual_seed(7)
    n = 300
    boxes = torch.cat([torch.rand(n, 2, generator=gen, dtype=torch.float64)
                       * 12,
                       torch.zeros(n, 1, dtype=torch.float64),
                       1 + 3 * torch.rand(n, 2, generator=gen,
                                          dtype=torch.float64),
                       torch.ones(n, 1, dtype=torch.float64),
                       torch.rand(n, 1, generator=gen, dtype=torch.float64)
                       * np.pi], dim=1)
    scores = torch.rand(n, generator=gen, dtype=torch.float64)
    post = {"score_threshold": 0.3, "nms_iou_threshold": 0.1,
            "pre_max_size": 256, "post_max_size": 256}
    idx, _, valid = rotated_nms_bev_batch(
        boxes[None], scores[None], iou_threshold=0.1, score_threshold=0.3,
        pre_max_size=256, post_max_size=256)
    kept = nms(boxes, scores, post)
    assert 5 < len(kept) < 100
    assert idx[0][valid[0]].tolist() == kept.tolist()
