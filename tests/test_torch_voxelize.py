"""PyTorch port: the point-major voxelizer equals the JAX voxelizer
(``slot_features=False``, no shuffle) exactly, including voxel and
per-voxel sample overflow and padding rows."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.ops.voxelize import voxelize as jax_voxelize
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.ops.voxelize import voxelize

CFG = Config(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
             voxel_shape=(32, 40, 10), image_size=(64, 96),
             max_points=512, max_voxels=96, samples_per_voxel=4,
             assign_window=6)


def _clouds(seed, B=3):
    rng = np.random.default_rng(seed)
    P = CFG.max_points
    pts = np.zeros((B, P, 6), np.float32)
    nums = np.array([P - 40, 200, 0][:B], np.int32)
    for b in range(B):
        n = nums[b]
        # clustered points: many land in the same voxel (rank >= T)
        centers = rng.uniform([0.5, -7.5, -2.5], [12.0, 7.5, 0.5], (40, 3))
        xyz = centers[rng.integers(0, 40, n)] + rng.normal(0, 0.2, (n, 3))
        # a few out of range
        xyz[: n // 20, 0] = -1.0
        pts[b, :n, :3] = xyz
        pts[b, :n, 3:] = rng.uniform(0, 1, (n, 3))
    return pts, nums


@pytest.mark.parametrize("seed", [0, 1])
def test_voxelize_matches_jax(seed):
    pts, nums = _clouds(seed)
    want = jax.vmap(lambda p, n: jax_voxelize(
        p, n, velo_range=CFG.velo_range, voxel_size=CFG.voxel_size,
        grid_shape=CFG.voxel_shape, max_voxels=CFG.max_voxels,
        samples_per_voxel=CFG.samples_per_voxel, slot_features=False))(
        jnp.asarray(pts), jnp.asarray(nums))
    got = voxelize(torch.from_numpy(pts), torch.from_numpy(nums),
                   velo_range=CFG.velo_range, voxel_size=CFG.voxel_size,
                   grid_shape=CFG.voxel_shape, max_voxels=CFG.max_voxels,
                   samples_per_voxel=CFG.samples_per_voxel)
    # the first frame overflows max_voxels
    assert int(want.num_voxels[0]) == CFG.max_voxels
    for name in ("coords", "counts", "num_voxels", "mask", "num_kept",
                 "sorted_points", "sorted_seg", "sorted_kept",
                 "sorted_to_orig"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)


def test_voxelize_with_permutation_matches_jax():
    """The training shuffle: JAX's ``jax.random.permutation`` of each
    frame, handed to the port as an explicit permutation."""
    pts, nums = _clouds(2)
    keys = jax.random.split(jax.random.key(7), len(pts))
    perm = np.stack([np.asarray(jax.random.permutation(k, CFG.max_points))
                     for k in keys])
    want = jax.vmap(lambda p, n, k: jax_voxelize(
        p, n, velo_range=CFG.velo_range, voxel_size=CFG.voxel_size,
        grid_shape=CFG.voxel_shape, max_voxels=CFG.max_voxels,
        samples_per_voxel=CFG.samples_per_voxel, shuffle_key=k,
        slot_features=False))(jnp.asarray(pts), jnp.asarray(nums), keys)
    got = voxelize(torch.from_numpy(pts), torch.from_numpy(nums),
                   velo_range=CFG.velo_range, voxel_size=CFG.voxel_size,
                   grid_shape=CFG.voxel_shape, max_voxels=CFG.max_voxels,
                   samples_per_voxel=CFG.samples_per_voxel,
                   perm=torch.from_numpy(perm))
    unshuffled = voxelize(torch.from_numpy(pts), torch.from_numpy(nums),
                          velo_range=CFG.velo_range,
                          voxel_size=CFG.voxel_size,
                          grid_shape=CFG.voxel_shape,
                          max_voxels=CFG.max_voxels,
                          samples_per_voxel=CFG.samples_per_voxel)
    # the shuffle changes which points a full voxel keeps
    assert not torch.equal(got.sorted_to_orig, unshuffled.sorted_to_orig)
    for name in ("coords", "counts", "num_voxels", "mask", "num_kept",
                 "sorted_points", "sorted_seg", "sorted_kept",
                 "sorted_to_orig"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
