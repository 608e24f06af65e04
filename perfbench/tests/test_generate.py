"""The generator repeats from a seed and meets its stated point counts."""

import json
import os

import numpy as np
import pytest

from perfbench import generate
from perfbench.reference import host

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
IMAGE = (370, 1224)
CAR = (3.9, 1.6, 1.56)


def mix(name, pool=3):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return {**json.load(f), "pool": pool}


@pytest.mark.parametrize("name", ["closed_b4", "open_10hz", "train_b4"])
def test_pool_repeats_from_a_seed(name):
    a = generate.make_pool(2 ** 33 + 17, mix(name), RANGE, IMAGE, CAR)
    b = generate.make_pool(2 ** 33 + 17, mix(name), RANGE, IMAGE, CAR)
    c = generate.make_pool(2 ** 33 + 18, mix(name), RANGE, IMAGE, CAR)
    for fa, fb in zip(a, b):
        assert np.array_equal(fa.scan, fb.scan)
        assert np.array_equal(fa.boxes, fb.boxes)
    assert not np.array_equal(a[0].scan[:100], c[0].scan[:100])


@pytest.mark.parametrize("name", ["closed_b4", "open_10hz", "train_b4"])
def test_point_counts(name):
    m = mix(name)
    for f in generate.make_pool(5, m, RANGE, IMAGE, CAR):
        lo = m["view_points"][0] + m["out_of_view_points"][0]
        hi = m["view_points"][1] + m["out_of_view_points"][1]
        assert lo <= len(f.scan) <= hi
        cloud = host.crop_project(f.scan, f.camera.rect, f.camera.proj,
                                  RANGE, IMAGE)
        assert m["view_points"][0] <= len(cloud) <= m["view_points"][1]
        assert len(f.boxes) == m["cars_in_view"]
        assert (f.image is not None) == m["images"]


def test_serving_scans_are_full_sweeps():
    f = generate.make_pool(9, mix("closed_b4", 1), RANGE, IMAGE, CAR)[0]
    assert 100_000 <= len(f.scan) <= 130_000
    az = np.arctan2(f.scan[:, 1], f.scan[:, 0])
    assert az.min() < -3.0 and az.max() > 3.0
    assert (f.scan[:, 0] < 0).mean() > 0.2


def test_no_point_on_the_view_border():
    m = mix("closed_b4", 2)
    for f in generate.make_pool(11, m, RANGE, IMAGE, CAR):
        inside = generate.in_view(f.scan, f.camera, RANGE, IMAGE)
        clear_in = generate.in_view(f.scan, f.camera, RANGE, IMAGE,
                                    m["edge_margin_px"], m["edge_margin_m"])
        clear_out = generate.out_of_view(f.scan, f.camera, RANGE, IMAGE,
                                         m["edge_margin_px"],
                                         m["edge_margin_m"])
        assert np.array_equal(inside, clear_in)
        assert np.all(clear_in | clear_out)
