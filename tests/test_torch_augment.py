"""PyTorch port: the GT database and the paste augmentation against the JAX
package.

``polygons_to_mask`` equals JAX's (``cv2.fillPoly``) on convex, concave,
self-touching, multi-part, partly outside and rectilinear polygons, and on
uncompressed RLE.  ``build_database`` in both modes (KINS with a fabricated
json, and rectangular masks) writes the same ``gtinfo.pkl``, the same velo
and mask bytes, and patches that decode to the same pixels.  With the same
``SeedSequence``, ``SceneAugmenter``, ``assemble_augmented_cloud`` and the
augmented ``preprocess_train_frame`` give JAX's results bit for bit.  The
trees: ``tests/test_data.write_mini_kitti``'s, and the port's
``write_kitti_tree`` (whose 2D boxes differ per car, so objects get
pasted).
"""

import json
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.data import augment as ja
from mvxnet_makise_tpu.data import gt_database as jdb
from mvxnet_makise_tpu.data import kitti as jk
from mvxnet_makise_tpu.train.loop import (
    preprocess_train_frame as jax_preprocess,
)
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data import augment as ta
from mvxnet_makise_tpu_torch.data import gt_database as tdb
from mvxnet_makise_tpu_torch.data import kitti as tk
from mvxnet_makise_tpu_torch.data.image_io import read_png
from mvxnet_makise_tpu_torch.data.synthetic import write_kitti_tree
from mvxnet_makise_tpu_torch.train.loop import preprocess_train_frame
from test_data import CFG as MINI_CFG
from test_data import write_mini_kitti

CFG = Config(max_points=MINI_CFG.max_points, max_boxes=MINI_CFG.max_boxes)
JCFG = JaxConfig(max_points=MINI_CFG.max_points,
                 max_boxes=MINI_CFG.max_boxes)


def _polygon_cases(rng):
    """(name, polygons) on a 60x80 image."""
    w, h = 80, 60
    cases = []
    for i in range(12):
        pts = rng.uniform(-8, [w + 8, h + 8], (9, 2)).astype(np.float32)
        cases.append(("convex", [cv2.convexHull(pts)[:, 0]]))
        k = int(rng.integers(5, 12))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(4, 28, k)
        c = rng.uniform([12, 12], [w - 12, h - 12])
        cases.append(("concave", [np.stack([c[0] + r * np.cos(ang),
                                            c[1] + r * np.sin(ang)], 1)]))
        cases.append(("parts", [rng.uniform(0, [w, h], (int(
            rng.integers(3, 7)), 2)) for _ in range(3)]))
        cases.append(("outside", [rng.uniform(-120, [w + 120, h + 120],
                                              (int(rng.integers(3, 8)),
                                               2))]))
        xs = np.sort(rng.integers(-6, w + 6, 4))
        ys = np.sort(rng.integers(-6, h + 6, 4))
        cases.append(("rectilinear", [np.array(
            [[xs[0], ys[0]], [xs[3], ys[0]], [xs[3], ys[1]], [xs[1], ys[1]],
             [xs[1], ys[3]], [xs[0], ys[3]]])]))
    cases.append(("self-touching", [np.array(
        [[10, 10], [40, 10], [25, 30], [40, 50], [10, 50], [25, 30]])]))
    cases.append(("bow-tie", [np.array([[5, 5], [60, 40], [60, 5],
                                        [5, 40]])]))
    return [(name, [p.ravel().tolist() for p in polys])
            for name, polys in cases]


def test_polygon_masks_match_cv2_fillpoly(rng):
    cases = _polygon_cases(rng)
    for name, segm in cases:
        np.testing.assert_array_equal(tdb.polygons_to_mask(segm, 60, 80),
                                      jdb.polygons_to_mask(segm, 60, 80),
                                      err_msg=f"{name}: {segm}")
    # a vertex list too short for a polygon draws nothing, as in JAX
    assert tdb.polygons_to_mask([[1, 2, 3, 4]], 10, 10).sum() == 0


def test_rle_masks_match_jax(rng):
    for h, w in ((4, 3), (17, 23)):
        runs = rng.integers(0, 9, 40)
        runs = runs[np.cumsum(runs) <= h * w]
        segm = {"counts": runs.tolist(), "size": [h, w]}
        np.testing.assert_array_equal(tdb.polygons_to_mask(segm, h, w),
                                      jdb.polygons_to_mask(segm, h, w))
    with pytest.raises(ValueError):
        tdb.polygons_to_mask({"counts": "abc", "size": [2, 2]}, 2, 2)


@pytest.fixture(params=["mini_kitti", "port_tree"])
def tree(request, tmp_path):
    rng = np.random.default_rng(0)
    if request.param == "mini_kitti":
        root, _ = write_mini_kitti(tmp_path, rng, n_frames=3)
    else:
        root = str(tmp_path / "kitti")
        write_kitti_tree(root, CFG, rng, 4, 1)
    return root


def _kins_json(root, path, rng):
    """A KINS-style json for every train frame: one annotation per car,
    its a_bbox the car's label box, its polygon a concave shape inside."""
    images, anns = [], []
    split = os.path.join(root, "ImageSets", "train.txt")
    for i, fid in enumerate(tk.read_split(split)):
        images.append({"id": i, "file_name": f"{fid}.png"})
        labels = tk.read_labels(os.path.join(root, "training", "label_2",
                                             fid + ".txt"))
        for box in labels["bbox2d"][labels["type"] == "Car"]:
            l, t, r, b = (float(v) for v in box)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
            rad = rng.uniform(0.3, 0.6, 8)
            cx, cy = (l + r) / 2, (t + b) / 2
            poly = np.stack([cx + rad * (r - l) * np.cos(ang),
                             cy + rad * (b - t) * np.sin(ang)], 1)
            anns.append({"image_id": i, "category_id": 4,
                         "a_bbox": [l, t, r - l, b - t],
                         "i_segm": [poly.ravel().tolist()]})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)


def _same_database(a_root, b_root):
    ga = os.path.join(a_root, "training", "gtdatabase")
    gb = os.path.join(b_root, "training", "gtdatabase")
    with open(os.path.join(ga, "gtinfo.pkl"), "rb") as f:
        info_a = pickle.load(f)
    with open(os.path.join(gb, "gtinfo.pkl"), "rb") as f:
        info_b = pickle.load(f)
    assert info_a.keys() == info_b.keys()
    n = 0
    for cls in info_a:
        assert len(info_a[cls]) == len(info_b[cls])
        for sa, sb in zip(info_a[cls], info_b[cls]):
            assert sa.keys() == sb.keys()
            for k in sa:
                if isinstance(sa[k], np.ndarray):
                    assert sa[k].dtype == sb[k].dtype, k
                    np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
                else:
                    assert sa[k] == sb[k], k
            for k in ("velo", "mask"):
                with open(os.path.join(ga, cls, sa[k]), "rb") as f:
                    raw_a = f.read()
                with open(os.path.join(gb, cls, sb[k]), "rb") as f:
                    assert f.read() == raw_a, k
            pa = os.path.join(ga, cls, sa["image"])
            pb = os.path.join(gb, cls, sb["image"])
            np.testing.assert_array_equal(read_png(pb), cv2.imread(pa))
            np.testing.assert_array_equal(cv2.imread(pb), read_png(pa))
            n += 1
    return n


@pytest.mark.parametrize("kins", [False, True])
def test_build_database_matches_jax(tree, tmp_path, kins):
    port_root = str(tmp_path / "port_copy")
    shutil.copytree(tree, port_root)
    kins_json = None
    if kins:
        kins_json = str(tmp_path / "kins.json")
        _kins_json(tree, kins_json, np.random.default_rng(1))
    want = jdb.build_database(tree, JCFG, kins_json=kins_json,
                              classes=("Car",))
    got = tdb.build_database(port_root, CFG, kins_json=kins_json,
                             classes=("Car",))
    assert got == want and got["Car"] > 0
    assert _same_database(tree, port_root) == got["Car"]
    if kins:
        mask = np.load(os.path.join(port_root, "training", "gtdatabase",
                                    "Car", "mask_000000.npy"))
        assert 0 < mask.sum() < mask.size          # a polygon, not the box


def test_ground_height_grid_matches_jax(rng):
    pts = rng.uniform([-5, -45, -4, 0], [75, 45, 2, 1],
                      (5000, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        ta.ground_height_grid(pts, CFG.velo_range),
        ja.ground_height_grid(pts, JCFG.velo_range))


def test_augmentation_matches_jax(tree):
    jdb.build_database(tree, JCFG, classes=("Car",))
    tdbase = tdb.load_database(tree, ["Car"])
    jdbase = jdb.load_database(tree, ["Car"])
    ids = tk.read_split(os.path.join(tree, "ImageSets", "train.txt"))
    tp, jp = tk.KittiPaths.from_root(tree), jk.KittiPaths.from_root(tree)
    pasted_total = 0
    for idx, fid in enumerate(ids):
        tf = tk.load_frame(tp, fid, CFG)
        jf = jk.load_frame(jp, fid, JCFG)

        def seeded():
            return np.random.default_rng(np.random.SeedSequence([0, 0, idx]))
        # the frame's own boxes, and an empty scene (the mini tree's cars
        # share one 2D box, so only an empty scene takes a paste there)
        for b2d, b3d in (((tf.bbox2d, tf.boxes), (jf.bbox2d, jf.boxes)),
                         (({}, {}), ({}, {}))):
            got = ta.SceneAugmenter(CFG, tdbase, rng=seeded())(
                tf.points, tf.image, *b2d, ["Car"], [12])
            want = ja.SceneAugmenter(JCFG, jdbase, rng=seeded())(
                jf.points, jf.image, *b3d, ["Car"], [12])
            assert len(got[0]) == len(want[0])
            for (gv, gc), (wv, wc) in zip(got[0], want[0]):
                np.testing.assert_array_equal(gv, wv)
                for a, b in zip(gc, wc):
                    np.testing.assert_array_equal(a, np.asarray(b))
            np.testing.assert_array_equal(got[1], want[1])
            for k in (2, 3):
                np.testing.assert_array_equal(got[k]["Car"], want[k]["Car"])
            np.testing.assert_array_equal(
                ta.assemble_augmented_cloud(tf.points, tf.calib, got[0]),
                ja.assemble_augmented_cloud(jf.points, jf.calib, want[0]))
            pasted_total += len(got[0])

        # the loop's host prep with the augmenter, from one generator
        rng_t, rng_j = seeded(), seeded()
        arrays = preprocess_train_frame(
            tf, CFG, ta.SceneAugmenter(CFG, tdbase, rng=rng_t), rng_t)
        want_fa, want_cls = jax_preprocess(
            jf, JCFG, ja.SceneAugmenter(JCFG, jdbase, rng=rng_j), rng_j)
        for name in want_fa._fields:
            np.testing.assert_array_equal(getattr(arrays, name),
                                          getattr(want_fa, name),
                                          err_msg=name)
        np.testing.assert_array_equal(arrays.gt_classes, want_cls)
    assert pasted_total > 0
