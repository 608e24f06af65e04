"""GT-sample database: offline build and in-RAM load (port of
``mvxnet_makise_tpu/data/gt_database.py``, numpy only).

``build_database`` matches KITTI 3D labels with KINS amodal-segmentation
masks by 2D IoU >= 0.65, crops each object's points with its oriented 3D
box, and stores per object a velo ``.bin``, the masked image patch (PNG)
and the mask (``.npy``), plus a ``gtinfo.pkl`` index.  Without KINS
(``kins_json=None``) every in-range labelled object is taken with its
KITTI 2D box as a rectangular mask.  The on-disk layout
(``training/gtdatabase/<cls>/{velo,img,mask}_NNNNNN.*`` + ``gtinfo.pkl``) is
the JAX package's, so a database built by either package loads in the
other.

KINS polygons are drawn by :func:`fill_poly`, which follows OpenCV's
``cv::fillPoly`` (``imgproc/src/drawing.cpp``, ``CollectPolyEdges`` and
``FillEdgeCollection``): each edge is drawn as an 8-connected line clipped
to the image, the non-horizontal edges are kept in 16.16 fixed point (an
edge that leaves the image runs through its clipped endpoints), and each
scanline is filled between pairs of edges, from the left edge rounded up
to the right edge rounded down.  So the masks are pixel for pixel those
the JAX package draws with ``cv2.fillPoly``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.image_io import read_png, write_png
from mvxnet_makise_tpu_torch.data.kitti import (
    KittiPaths,
    read_labels,
    read_split,
)
from mvxnet_makise_tpu_torch.geometry.boxes import boxes_cam_to_lidar
from mvxnet_makise_tpu_torch.geometry.boxes_np import points_in_box3d
from mvxnet_makise_tpu_torch.geometry.calib import read_calib

KINS_CLASS_IDS = {"Cyclist": 1, "Pedestrian": 2, "Car": 4}

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
_INT_MAX = 2**31 - 1


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int,
               y2: int):
    """``cv::clipLine(Size2l, Point2l&, Point2l&)``: (inside, x1, y1, x2,
    y2) with the endpoints moved onto the image border, in OpenCV's
    order and double-precision rounding."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
               value) -> None:
    """``cv::line`` with ``LINE_8``: OpenCV's left-to-right 8-connected
    ``LineIterator`` over the segment clipped to the image."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=_INT_MAX, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_edges(img, poly, value, edges: List[_Edge]) -> None:
    """``CollectPolyEdges`` (shift 0, no offset, ``LINE_8``): draw each
    edge, and keep the non-horizontal ones as fixed-point edges."""
    h, w = img.shape[:2]
    x0, y0 = int(poly[-1][0]) << _XY_SHIFT, int(poly[-1][1])
    for px, py in poly:
        x1, y1 = int(px) << _XY_SHIFT, int(py)
        t0x = (x0 + (_XY_ONE >> 1)) >> _XY_SHIFT
        t1x = (x1 + (_XY_ONE >> 1)) >> _XY_SHIFT
        _draw_line(img, t0x, y0, t1x, y1, value)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= y0 < h
                and 0 <= y1 < h):
            # an edge that leaves the image runs through its clipped
            # endpoints (a vertical edge where they share a row)
            inside, a_x, a_y, b_x, b_y = _clip_line(w, h, t0x, y0, t1x, y1)
            if inside:
                c0x, c0y = a_x << _XY_SHIFT, a_y
                c1x, c1y = b_x << _XY_SHIFT, b_y
        if y0 != y1:
            dx = _tdiv(c1x - c0x, c1y - c0y) if c1y != c0y else 0
            if y0 < y1:
                edges.append(_Edge(y0, y1, c0x + (y0 - c0y) * dx, dx))
            else:
                edges.append(_Edge(y1, y0, c1x + (y1 - c1y) * dx, dx))
        x0, y0 = x1, y1


def _fill_edges(img, edges: List[_Edge], value) -> None:
    """``FillEdgeCollection`` (``LINE_8``): an active-edge scanline fill
    between pairs of edges, the active list kept sorted by x."""
    h, w = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    ends = [e.x for e in edges] + [e.x + (e.y1 - e.y0) * e.dx
                                   for e in edges]
    if y_max < 0 or y_min >= h or max(ends) < 0 \
            or min(ends) >= (w << _XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge())                     # sentinel, y0 = INT_MAX
    head = _Edge()                            # list head of active edges
    i, e = 0, edges[0]
    for y in range(e.y0, min(y_max, h)):
        draw = False
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                # the edge ends on this row: drop it
                prelast.next = last = last.next
                continue
            keep = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                # the next edge starts on this row: insert it
                prelast.next, e.next = e, last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    # the span: from the left edge rounded up to the
                    # right edge rounded down
                    lo, hi = sorted((keep.x, prelast.x))
                    x1 = (lo + _XY_ONE - 1) >> _XY_SHIFT
                    x2 = hi >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = value
                keep.x += keep.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble-sort the active list by x
        stop = None
        while True:
            prelast, last, exchanged = head, head.next, None
            while last is not stop and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next, last.next, te.next = te, te.next, last
                    prelast = exchanged = te
                else:
                    prelast, last = last, te
            if exchanged is None:
                break
            stop = exchanged
            if stop is head.next or stop is head:
                break


def fill_poly(img: np.ndarray, polys: Sequence[np.ndarray], value) -> None:
    """``cv2.fillPoly(img, polys, value)`` on int vertices (each poly
    (N, 2) x y), in place."""
    edges: List[_Edge] = []
    for poly in polys:
        _collect_edges(img, [(int(x), int(y)) for x, y in poly], value,
                       edges)
    _fill_edges(img, edges, value)


def polygons_to_mask(segm, height: int, width: int) -> np.ndarray:
    """COCO-style segmentation -> uint8 {0,1} mask.

    Accepts polygon lists ([[x0, y0, x1, y1, ...], ...]) or an
    uncompressed RLE dict ({'counts': [...], 'size': [h, w]}).
    """
    if isinstance(segm, dict):
        counts = segm["counts"]
        h, w = segm["size"]
        if isinstance(counts, (bytes, str)):
            raise ValueError("compressed RLE unsupported; expected "
                             "polygon or uncompressed RLE")
        flat = np.zeros(h * w, dtype=np.uint8)
        pos = 0
        val = 0
        for run in counts:
            if val:
                flat[pos:pos + run] = 1
            pos += run
            val ^= 1
        # COCO RLE is column-major
        return flat.reshape((w, h)).T[:height, :width]

    mask = np.zeros((height, width), dtype=np.uint8)
    polys = [np.asarray(p, dtype=np.float64).reshape(-1, 2).astype(np.int32)
             for p in segm if len(p) >= 6]
    if polys:
        fill_poly(mask, polys, 1)
    return mask


def _iou_2d(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """Pairwise xyxy IoU."""
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-9)


def _load_kins_index(kins_json: str):
    """KINS 2020 json -> (image_id -> file name, image_id -> [ann])."""
    with open(kins_json, "r") as f:
        info = json.load(f)
    imgs = {im["id"]: im["file_name"] for im in info["images"]}
    anns: Dict[int, list] = {}
    for ann in info["annotations"]:
        anns.setdefault(ann["image_id"], []).append(ann)
    return imgs, anns


def build_database(root: str, cfg: Config,
                   kins_json: Optional[str] = None,
                   classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
                   limit: Optional[int] = None) -> Dict[str, int]:
    """Build ``training/gtdatabase`` from the train split (module
    docstring).  Returns per-class sample counts."""
    paths = KittiPaths.from_root(root)
    gtroot = os.path.join(root, "training", "gtdatabase")
    os.makedirs(gtroot, exist_ok=True)
    for c in classes:
        os.makedirs(os.path.join(gtroot, c), exist_ok=True)

    train_ids = read_split(paths.train_split)
    if limit:
        train_ids = train_ids[:limit]
    train_set = set(train_ids)

    kins = None
    if kins_json is not None:
        imgs, anns = _load_kins_index(kins_json)
        kins = {}
        for img_id, fname in imgs.items():
            fid = os.path.splitext(os.path.basename(fname))[0][:6]
            if fid in train_set:
                kins[fid] = anns.get(img_id, [])

    gtinfo: Dict[str, List[dict]] = {c: [] for c in classes}
    counters = {c: 0 for c in classes}
    im_h, im_w = cfg.image_size

    frame_ids = sorted(kins.keys()) if kins is not None else train_ids
    for fid in frame_ids:
        img = read_png(os.path.join(paths.image, fid + ".png"))
        if img is None:
            continue
        full_h, full_w = img.shape[:2]
        img = img[:im_h, :im_w]

        velo_dir = paths.velodyne_cropped if os.path.isdir(
            paths.velodyne_cropped) else paths.velodyne
        velo = np.fromfile(os.path.join(velo_dir, fid + ".bin"),
                           dtype=np.float32).reshape(-1, 4)
        calib = read_calib(os.path.join(paths.calib, fid + ".txt"))
        c2v = np.linalg.inv(np.asarray(calib.velo_to_cam))
        labels = read_labels(os.path.join(paths.label, fid + ".txt"))

        lo = np.asarray(cfg.velo_range[:3], np.float32)
        hi = np.asarray(cfg.velo_range[3:6], np.float32)

        for cls in classes:
            sel = labels["type"] == cls
            if not np.any(sel):
                continue
            cam = labels["cam_box"][sel]
            b2d = labels["bbox2d"][sel]
            occ = labels["occluded"][sel]
            lidar = np.asarray(boxes_cam_to_lidar(cam, c2v), np.float32)
            in_range = np.all(
                (lidar[:, :3] >= lo) & (lidar[:, :3] < hi), axis=1)
            lidar, b2d, occ = lidar[in_range], b2d[in_range], occ[in_range]
            if len(lidar) == 0:
                continue

            if kins is not None:
                cls_id = KINS_CLASS_IDS[cls]
                cls_anns = [a for a in kins[fid]
                            if a["category_id"] == cls_id]
                if not cls_anns:
                    continue
                mask_boxes = []
                for a in cls_anns:
                    x, y, w, h = a["a_bbox"]
                    mask_boxes.append([x, y, x + w, y + h])
                mask_boxes = np.asarray(mask_boxes, np.float32)
                ious = _iou_2d(b2d, mask_boxes)
                best = ious.argmax(axis=1)
                ok = ious[np.arange(len(b2d)), best] >= 0.65
            else:
                best = np.zeros(len(b2d), dtype=int)
                ok = np.ones(len(b2d), dtype=bool)

            for gi in np.nonzero(ok)[0]:
                box3d, box2d = lidar[gi], b2d[gi]
                if kins is not None:
                    ann = cls_anns[best[gi]]
                    mask = polygons_to_mask(
                        ann.get("i_segm") or ann.get("segmentation"),
                        full_h, full_w)[:im_h, :im_w]
                    x, y, w, h = ann["a_bbox"]
                    mb = np.asarray([x, y, x + w, y + h], np.int32)
                else:
                    mb = box2d.astype(np.int32)
                    mask = np.zeros((im_h, im_w), np.uint8)
                    mask[mb[1]:mb[3] + 1, mb[0]:mb[2] + 1] = 1
                mb = np.clip(mb, 0, [im_w - 1, im_h - 1,
                                     im_w - 1, im_h - 1])
                roi_mask = mask[mb[1]:mb[3] + 1, mb[0]:mb[2] + 1]
                roi_img = img[mb[1]:mb[3] + 1, mb[0]:mb[2] + 1] \
                    * roi_mask[..., None]
                if roi_img.size == 0:
                    continue

                inside = points_in_box3d(velo, box3d)
                obj_velo = velo[inside]

                k = counters[cls]
                veloname = f"velo_{k:06d}.bin"
                imgname = f"img_{k:06d}.png"
                maskname = f"mask_{k:06d}.npy"
                cdir = os.path.join(gtroot, cls)
                obj_velo.astype(np.float32).tofile(
                    os.path.join(cdir, veloname))
                write_png(os.path.join(cdir, imgname), roi_img)
                np.save(os.path.join(cdir, maskname), roi_mask)
                gtinfo[cls].append({
                    "velo": veloname, "image": imgname, "mask": maskname,
                    "occlude": float(occ[gi]), "maskbbox": mb,
                    "bbox2d": box2d.astype(np.float32),
                    "bbox3d": box3d.astype(np.float32), "id": fid,
                })
                counters[cls] += 1

    with open(os.path.join(gtroot, "gtinfo.pkl"), "wb") as f:
        pickle.dump(gtinfo, f)
    return counters


def load_database(root: str,
                  classes: Sequence[str]) -> Dict[str, List[dict]]:
    """Load the whole database into RAM.  Each sample dict carries
    velo/image/mask arrays plus boxes and the source frame's calib.

    ``gtinfo.pkl`` is a pickle: load only databases this program (or the
    JAX package) built."""
    paths = KittiPaths.from_root(root)
    gtroot = os.path.join(root, "training", "gtdatabase")
    with open(os.path.join(gtroot, "gtinfo.pkl"), "rb") as f:
        gtinfo = pickle.load(f)

    out: Dict[str, List[dict]] = {}
    calib_cache = {}
    for cls in classes:
        samples = []
        for info in gtinfo.get(cls, []):
            cdir = os.path.join(gtroot, cls)
            velo = np.fromfile(os.path.join(cdir, info["velo"]),
                               dtype=np.float32).reshape(-1, 4)
            img = read_png(os.path.join(cdir, info["image"]))
            mask = np.load(os.path.join(cdir, info["mask"]))
            fid = info["id"]
            if fid not in calib_cache:
                calib_cache[fid] = read_calib(
                    os.path.join(paths.calib, fid + ".txt"))
            samples.append({
                "velo": velo, "image": img, "mask": mask,
                "maskbbox": np.asarray(info["maskbbox"], np.int32),
                "bbox2d": np.asarray(info["bbox2d"], np.float32),
                "bbox3d": np.asarray(info["bbox3d"], np.float32),
                "calib": calib_cache[fid],
            })
        out[cls] = samples
    return out
