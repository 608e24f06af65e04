"""The FLOP and byte formulas against counts made by hand at small
shapes."""

import torch

from perfbench.accounting import PEAKS, bytes as kbytes, flops, frames


def test_conv_and_rpn_by_hand():
    assert flops.conv(2, 3, 3, 4, 5) == 2 * 2 * 3 * 9 * 20
    # one stride-2 stage of one conv and nothing else, by hand
    h, w = 8, 10
    total = flops.rpn(h, w, cin=4, anchors=1)
    h1, w1, h2, w2, h3, w3 = 4, 5, 2, 3, 1, 2
    want = (2 * 4 * 128 * 9 * h1 * w1 + 3 * 2 * 128 * 128 * 9 * h1 * w1
            + 6 * 2 * 128 * 128 * 9 * h2 * w2
            + 2 * 128 * 256 * 9 * h3 * w3 + 5 * 2 * 256 * 256 * 9 * h3 * w3
            + 2 * 128 * 256 * 9 * h1 * w1 + 2 * 128 * 256 * 4 * h2 * w2
            + 2 * 256 * 256 * 16 * h3 * w3 + 2 * 768 * 8 * h1 * w1)
    assert total == want


def test_resnet_fpn_at_the_reference_image():
    # 370 x 1224 -> 402 x 1332 -> padded 416 x 1344 (torchvision's rule)
    assert flops.padded_image((370, 1224)) == (416, 1344)
    g = flops.resnet_fpn(416, 1344) / 1e9
    # ResNet50 is 4.1 GMAC at 224 x 224; at 416 x 1344 (11.1x the pixels)
    # with the FPN's laterals and outputs, about 2 x 4.1 x 11.1 + 57
    assert 140 < g < 160


def test_conv1_pairs_by_hand():
    grid = (4, 5, 10)
    # a voxel in the grid's corner at depth 0: 2 x 2 spatial taps inside
    # the grid, output depths 0 (reads -1, 0, 1) only
    c = torch.tensor([[0, 0, 0]])
    assert frames.conv1_pairs(c, grid) == 4
    # an inner voxel at depth 3: 9 taps, output depths 1 (1..3) and 2
    # (3..5)
    c = torch.tensor([[2, 2, 3]])
    assert frames.conv1_pairs(c, grid) == 18


def test_touched_cells_by_hand():
    rc = torch.tensor([[0.0, 0.0], [0.0, 0.5]])
    # a 2 x 2 level over a 4 x 4 image: both points read cells 0, 1, 2, 3
    # of the clamped taps around (0, 0)
    assert frames.touched_cells(rc, (4.0, 4.0), (2, 2)) == 4


def test_frame_flops_by_hand():
    cfg = {"voxel_shape": (4, 6, 10), "image_size": (32, 32),
           "image_min_side": 0}
    st = {"kept_points": 10, "voxels": 3, "conv1_pairs": 7}
    f = flops.frame(st, cfg, with_images=False)
    assert f["vfe"] == 2 * (7 * 16 + 32 * 64 + 128 * 128) * 13
    assert f["cml"] == 2 * 128 * 64 * 7 + 2 * 64 * 64 * 27 * 4 * 6 * (3 + 2)
    g = flops.frame(st, cfg, with_images=True)
    assert g["fusion_mlp"] == 2 * (768 * 768 + 768 * 128 + 128 * 128
                                   + 128 * 16 + 16 * 16) * 11
    assert flops.train(st, cfg, True) == g["image_trunk"] + 3 * (
        sum(g.values()) - g["image_trunk"])


def test_kernel_bytes_by_hand():
    cfg = {"voxel_shape": (4, 6, 10), "max_voxels": 8, "max_points": 16}
    fr = [{"live_columns": 2, "kept_points": 5, "k2_touched_cells": 3}]
    R = 64 * 5
    want = (2 * 9 * R * 2 + 8 * 4 + 5 * 4 + R * 4 + 4 * 6 * R * 2
            + 2 * R * 4)
    ops = 2 * 9 * R + 5 * 4 * 6 * R
    assert kbytes.k1(fr, cfg, 2) == max(want / PEAKS["hbm_bytes_per_s"],
                                        ops / PEAKS["f32_flop_per_s"])
    want2 = 16 * 768 * 4 + 16 * 8 + 16 + 3 * 256 * 4
    assert kbytes.k2(fr, cfg, 4) == max(want2 / PEAKS["hbm_bytes_per_s"],
                                        5 * 768 * 7 / PEAKS["f32_flop_per_s"])
