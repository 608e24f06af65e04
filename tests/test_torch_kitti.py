"""PyTorch port: KITTI loading, the host pipeline, the offline crop and the
synthetic frames, against the JAX package on the tree that
``tests/test_data.write_mini_kitti`` writes.

``load_frame`` / ``load_dataset``: points and images bit-equal, boxes,
``bbox2d`` and difficulty equal.  ``preprocess_frame`` / ``collate`` equal.
``tools.cropdata``'s native, numpy and torch (CPU) modes give the points
of JAX's native and numpy modes.  ``synthetic_frame_multiclass`` draws
the JAX package's frame from the same generator.
"""

import os

import numpy as np
import pytest

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.data import kitti as jk
from mvxnet_makise_tpu.data.pipeline import collate as jax_collate
from mvxnet_makise_tpu.data.pipeline import (
    preprocess_frame as jax_preprocess_frame,
)
from mvxnet_makise_tpu.data.synthetic import (
    synthetic_frame_multiclass as jax_multiclass,
)
from mvxnet_makise_tpu.geometry.calib import read_calib as jax_read_calib
from mvxnet_makise_tpu.tools.cropdata import crop_frame as jax_crop_frame
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data import kitti as tk
from mvxnet_makise_tpu_torch.data.pipeline import collate, preprocess_frame
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame_multiclass
from mvxnet_makise_tpu_torch.geometry.calib import Calib, read_calib
from mvxnet_makise_tpu_torch.tools import cropdata
from test_data import write_mini_kitti

KW = dict(max_points=32768, max_boxes=8)
CFG, JCFG = Config(**KW), JaxConfig(**KW)


def _same_frame(got, want):
    assert got.frame_id == want.frame_id
    np.testing.assert_array_equal(got.points, want.points)
    if want.image is None:
        assert got.image is None
    else:
        assert got.image.dtype == want.image.dtype == np.float32
        np.testing.assert_array_equal(got.image, want.image)
    for a, b in zip(got.calib, want.calib):
        np.testing.assert_array_equal(a, np.asarray(b))
    for field in ("boxes", "bbox2d", "difficulty"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.keys() == w.keys(), field
        for k in w:
            assert g[k].dtype == w[k].dtype, (field, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=field)


@pytest.fixture
def tree(tmp_path, rng):
    root, frames = write_mini_kitti(tmp_path, rng, n_frames=3)
    return root, sorted(frames)


@pytest.mark.parametrize("use_cropped,load_image", [(False, True),
                                                    (True, False)])
def test_load_frame_matches_jax(tree, use_cropped, load_image):
    root, ids = tree
    if use_cropped:
        assert cropdata.main([root, "numpy", "--device", "cpu"]) == 0
    tp, jp = tk.KittiPaths.from_root(root), jk.KittiPaths.from_root(root)
    for fid in ids:
        got = tk.load_frame(tp, fid, CFG, use_cropped=use_cropped,
                            load_image=load_image)
        want = jk.load_frame(jp, fid, JCFG, use_cropped=use_cropped,
                             load_image=load_image)
        _same_frame(got, want)
        assert len(got.boxes["Car"]) == 3


def test_load_dataset_and_labels_match_jax(tree):
    root, ids = tree
    for split in ("train", "val"):
        got = tk.load_dataset(root, split, CFG, limit=2)
        want = jk.load_dataset(root, split, JCFG, limit=2)
        assert len(got) == len(want) == (2 if split == "train" else 1)
        for g, w in zip(got, want):
            _same_frame(g, w)
    path = os.path.join(root, "training", "label_2", ids[0] + ".txt")
    g, w = tk.read_labels(path), jk.read_labels(path)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
    assert list(tk.read_labels(path + ".missing")["type"]) == []
    bbox = np.array([[0, 0, 10, 50], [0, 0, 10, 30], [0, 0, 10, 20],
                     [0, 0, 10, 50]], np.float32)
    trunc = np.array([0.0, 0.2, 0.0, 0.6], np.float32)
    occ = np.array([0, 1, 0, 3], np.float32)
    np.testing.assert_array_equal(tk._difficulty(bbox, trunc, occ),
                                  jk._difficulty(bbox, trunc, occ))


def test_preprocess_frame_and_collate_match_jax(tree):
    root, ids = tree
    frames = tk.load_dataset(root, "train", CFG)
    small = CFG.replace(max_points=2000)
    got, want = [], []
    for f, cfg, jcfg in ((frames[0], CFG, JCFG),
                         (frames[1], small, JCFG.replace(max_points=2000))):
        jcal = jk.Calib(*f.calib)
        got.append(preprocess_frame(f.points, f.calib, f.image,
                                    f.boxes["Car"], cfg))
        want.append(jax_preprocess_frame(f.points, jcal, f.image,
                                         f.boxes["Car"], jcfg))
    got[1] = got[1]._replace(points=np.zeros_like(got[0].points))
    want[1] = want[1]._replace(points=np.zeros_like(want[0].points))
    for g, w in zip(got + [collate(got)], want + [jax_collate(want)]):
        for name in w._fields:
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name), err_msg=name)


def test_preprocess_frame_subsamples_and_pads_like_jax(rng):
    cfg, jcfg = CFG.replace(max_points=700), JCFG.replace(max_points=700)
    pts = rng.uniform(0, 30, (1000, 4)).astype(np.float32)
    img = rng.integers(0, 256, (300, 1000, 3)).astype(np.uint8)
    calib = Calib(*[np.eye(4, dtype=np.float32)] * 3)
    got = preprocess_frame(pts, calib, img, None, cfg)
    want = jax_preprocess_frame(pts, jk.Calib(*calib), img, None, jcfg)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_crop_modes_match_jax(tree):
    root, ids = tree
    velo = os.path.join(root, "training", "velodyne")
    for fid in ids:
        pts = np.fromfile(os.path.join(velo, fid + ".bin"),
                          np.float32).reshape(-1, 4)
        path = os.path.join(root, "training", "calib", fid + ".txt")
        calib, jcal = read_calib(path), jax_read_calib(path)
        want = jax_crop_frame(pts, jcal, JCFG, "numpy")
        np.testing.assert_array_equal(
            jax_crop_frame(pts, jcal, JCFG, "native"), want)
        assert 1000 < len(want) < len(pts)
        for mode in cropdata.MODES:
            np.testing.assert_array_equal(
                cropdata.crop_frame(pts, calib, CFG, mode), want,
                err_msg=mode)


def test_cropdata_cli_writes_the_crop(tree):
    root, ids = tree
    assert cropdata.main([root, "torch", "1", "--device", "cpu"]) == 0
    p = tk.KittiPaths.from_root(root)
    for fid in ids:
        got = np.fromfile(os.path.join(p.velodyne_cropped, fid + ".bin"),
                          np.float32).reshape(-1, 4)
        raw = np.fromfile(os.path.join(p.velodyne, fid + ".bin"),
                          np.float32).reshape(-1, 4)
        want = jax_crop_frame(raw, jax_read_calib(
            os.path.join(p.calib, fid + ".txt")), JCFG, "native")
        np.testing.assert_array_equal(got, want)


def test_synthetic_multiclass_matches_jax():
    kw = dict(target_classes=("Car", "Pedestrian", "Cyclist"),
              augment_fill_to=(12, 4, 4))
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    got = synthetic_frame_multiclass(np.random.default_rng(3), cfg)
    want = jax_multiclass(np.random.default_rng(3), jcfg)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3].keys() == want[3].keys()
    for c in want[3]:
        np.testing.assert_array_equal(got[3][c], want[3][c])
