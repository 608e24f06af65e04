"""ctypes bindings for the host feed's C++ kernels (``csrc/pointcloud.cpp``).

Port of the serving half of ``mvxnet_makise_tpu/data/native.py``
(``assemble_frame``, ``assemble_batch`` and the numpy crop).  The package
keeps its own copy of the C++ source; it is compiled with g++ on first
use into the package's ``build/`` directory (listed in ``.gitignore``)
and bound with ctypes.  Without g++, :func:`assemble_frame` falls back to
numpy with the same boundary semantics.

Trap kept from the original: the numpy fallback of :func:`assemble_frame`
shuffles with ``np.random.default_rng`` while the C++ path uses its own
``mt19937_64``, so the two order points differently — and voxel sampling
keeps the first T points per voxel, so the order changes detections.
Compare two pipelines only on the same feed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from mvxnet_makise_tpu_torch.geometry.calib import Calib

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "pointcloud.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
_LIB_PATH = os.path.join(BUILD_DIR, "libpointcloud.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if not os.path.exists(_LIB_PATH) or \
            os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build under a private name, then rename: concurrent processes
        # (test workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            os.unlink(tmp)
            _build_failed = True
            return None
        os.replace(tmp, _LIB_PATH)
    dll = ctypes.CDLL(_LIB_PATH)
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    dll.assemble_frame.restype = i64
    dll.assemble_frame.argtypes = [f32p, i64, f32p, f32p, f32p, f32p,
                                   ctypes.c_uint64, i64, f32p]
    return dll


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
    return _lib


def available() -> bool:
    return get_lib() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _prep(points, calib: Calib, velo_range, image_size):
    pts = np.ascontiguousarray(points[:, :4], dtype=np.float32)
    rect = np.ascontiguousarray(
        np.asarray(calib.R0) @ np.asarray(calib.velo_to_cam),
        dtype=np.float32)
    proj = np.ascontiguousarray(
        np.asarray(calib.P2) @ rect, dtype=np.float32)
    rng6 = np.asarray(velo_range, dtype=np.float32)
    ims = np.asarray(image_size, dtype=np.float32)
    return pts, rect, proj, rng6, ims


def crop_project_numpy(points: np.ndarray, calib: Calib, velo_range,
                       image_size) -> np.ndarray:
    """Numpy version with the native kernel's boundary semantics:
    half-open range crop, positive camera depth, and the image bound
    ``0 <= uv < imsize - 1e-3``."""
    pts = np.asarray(points[:, :4], dtype=np.float32)
    lo = np.asarray(velo_range[:3], np.float32)
    hi = np.asarray(velo_range[3:6], np.float32)
    keep = np.all((pts[:, :3] >= lo) & (pts[:, :3] < hi), axis=1)
    pts = pts[keep]

    rect = np.asarray(calib.R0, np.float32) @ \
        np.asarray(calib.velo_to_cam, np.float32)
    proj = np.asarray(calib.P2, np.float32) @ rect
    hom = np.concatenate(
        [pts[:, :3], np.ones((len(pts), 1), np.float32)], axis=1)
    cam = hom @ rect.T
    front = cam[:, 2] > 0
    pts, hom = pts[front], hom[front]
    img = hom @ proj.T
    uv = img[:, :2] / img[:, 2:3]
    h, w = image_size
    ok = (uv[:, 0] >= 0) & (uv[:, 0] < w - 1e-3) & \
         (uv[:, 1] >= 0) & (uv[:, 1] < h - 1e-3)
    pts, uv = pts[ok], uv[ok]
    return np.concatenate(
        [pts, uv[:, 1:2], uv[:, 0:1]], axis=1).astype(np.float32)


def assemble_frame(points: np.ndarray, calib: Calib, velo_range,
                   image_size, capacity: int,
                   seed: int = 0) -> Tuple[np.ndarray, int]:
    """Fused crop+project+shuffle+pad into a (capacity, 6) buffer.
    Returns (buffer, num_real_rows)."""
    lib = get_lib()
    if lib is None:
        cloud = crop_project_numpy(points, calib, velo_range, image_size)
        rng = np.random.default_rng(seed)
        rng.shuffle(cloud, axis=0)
        n = min(len(cloud), capacity)
        out = np.zeros((capacity, 6), dtype=np.float32)
        out[:n] = cloud[:n]
        return out, n
    pts, rect, proj, rng6, ims = _prep(points, calib, velo_range, image_size)
    # the native path needs room for all cropped points before padding
    out = np.zeros((max(capacity, len(pts)), 6), dtype=np.float32)
    n = lib.assemble_frame(_fp(pts), len(pts), _fp(rect), _fp(proj),
                           _fp(rng6), _fp(ims), seed, capacity, _fp(out))
    return np.ascontiguousarray(out[:capacity]), int(n)


def assemble_batch(frames, velo_range, image_size, capacity: int, B: int,
                   pool=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble (points, calib, image-or-None) frames into ``(B, capacity,
    6) points / (B,) counts / (B, H, W, 3) images`` numpy arrays.

    With ``pool`` (a ThreadPoolExecutor) frames assemble concurrently:
    the ctypes call releases the GIL, the C++ kernel keeps no global
    state, and each worker writes a disjoint batch row.  Serial and
    pooled paths are bit-identical (fixed per-frame seed)."""
    pts = np.zeros((B, capacity, 6), np.float32)
    nums = np.zeros((B,), np.int32)
    imgs = np.zeros((B, *image_size, 3), np.float32)

    def one(i, points, calib, image):
        buf, n = assemble_frame(points, calib, velo_range, image_size,
                                capacity, seed=0)
        pts[i], nums[i] = buf, n
        if image is not None:
            img = np.asarray(image, np.float32)
            if img.max() > 1.5:
                img = img / 255.0
            h, w = image_size
            imgs[i, :img.shape[0], :img.shape[1]] = img[:h, :w]

    if pool is not None and len(frames) > 1:
        # list() drains the iterator so worker exceptions re-raise
        list(pool.map(lambda t: one(*t),
                      [(i, *f) for i, f in enumerate(frames)]))
    else:
        for i, f in enumerate(frames):
            one(i, *f)
    return pts, nums, imgs
