"""PyTorch port: the host feed and synthetic frames match the JAX
package's bit for bit (same C++ kernel, same numpy fallbacks)."""

import numpy as np
import pytest

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.data import native as jax_native
from mvxnet_makise_tpu.data.synthetic import synthetic_frame as jax_frame
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data import native
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, samples_per_voxel=8, assign_window=6)


def _frames(seed, n=2, num_points=1500):
    a = [jax_frame(np.random.default_rng(seed + i), JaxConfig(**KW),
                   num_cars=2, num_points=num_points) for i in range(n)]
    b = [synthetic_frame(np.random.default_rng(seed + i), Config(**KW),
                         num_cars=2, num_points=num_points)
         for i in range(n)]
    return a, b


def test_synthetic_frames_match_jax():
    a, b = _frames(0)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa[0], fb[0])
        for ma, mb in zip(fa[1], fb[1]):
            np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(fa[2], fb[2])
        np.testing.assert_array_equal(fa[3], fb[3])


@pytest.mark.parametrize("capacity", [256, 4096])
def test_assemble_frame_matches_jax_bit_for_bit(capacity):
    assert native.available() and jax_native.available()
    a, b = _frames(1)
    cfg = Config(**KW)
    for (pa, ca, _, _), (pb, cb, _, _) in zip(a, b):
        want, n_want = jax_native.assemble_frame(
            pa, ca, cfg.velo_range, cfg.image_size, capacity, seed=3)
        got, n_got = native.assemble_frame(
            pb, cb, cfg.velo_range, cfg.image_size, capacity, seed=3)
        assert n_got == n_want
        assert got.tobytes() == want.tobytes()


def test_crop_project_numpy_matches_jax():
    _, b = _frames(2)
    cfg = Config(**KW)
    pts, calib = b[0][0], b[0][1]
    # raw scan: points outside the range and behind the camera too
    rng = np.random.default_rng(0)
    raw = np.concatenate([pts, rng.uniform(-20, 20, (300, 4))
                          .astype(np.float32)])
    want = jax_native.crop_project_numpy(raw, calib, cfg.velo_range,
                                         cfg.image_size)
    got = native.crop_project_numpy(raw, calib, cfg.velo_range,
                                    cfg.image_size)
    assert 0 < len(got) < len(raw)
    np.testing.assert_array_equal(got, want)


def test_assemble_batch_matches_jax_serial_and_pooled():
    from concurrent.futures import ThreadPoolExecutor

    a, b = _frames(3, n=3)
    cfg = Config(**KW)
    want = jax_native.assemble_batch([f[:3] for f in a], cfg.velo_range,
                                     cfg.image_size, 512, 4)
    with ThreadPoolExecutor(2) as pool:
        for p in (None, pool):
            got = native.assemble_batch([f[:3] for f in b], cfg.velo_range,
                                        cfg.image_size, 512, 4, pool=p)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
