"""PyTorch port: the point-major LiDAR branch against the JAX package.

One voxelized batch of two synthetic frames (the port's voxelizer, which
``test_torch_voxelize.py`` holds equal to JAX's) goes through the JAX
modules, one sample at a time as ``norm_scope="sample"`` runs them, and
through the port's modules on the whole batch, with the same weights
(``models/weights.load_jax_params``).  Per module: the VFE stack with
per-voxel pooling, the column CML (whose conv1 runs K1's plain version),
the RPN, and the whole branch.

float64 on both sides (the JAX modules under ``jax.enable_x64``, which
selects the XLA composition of K1): tolerance 1e-8, summation order
only.  One float32 case runs JAX's K1 as the Pallas kernel (interpret
mode): tolerance 5e-4 absolute, 1e-4 relative — float32 sums over a
32x40 grid in another order (JAX folds the depth taps into a 3.3x larger
matmul), through three one-pass standardizations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.models.blocks import (
    DenseReluNormVirtualWeighted as JaxDenseVW,
)
from mvxnet_makise_tpu.models.voxelnet import RPN as JaxRPN
from mvxnet_makise_tpu.models.voxelnet import (
    MiddleConvLayersColumn as JaxCML,
)
from mvxnet_makise_tpu.models.voxelnet_pm import _NEG
from mvxnet_makise_tpu.models.voxelnet_pm import PointSVFE as JaxSVFE
from mvxnet_makise_tpu.models.voxelnet_pm import (
    VoxelNetBranchPM as JaxBranch,
)
from mvxnet_makise_tpu.models.voxelnet_pm import _segment_max
from mvxnet_makise_tpu.models.voxelnet_pm import (
    point_lidar_features as jax_point_lidar_features,
)
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data import native
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models.voxelnet import RPN
from mvxnet_makise_tpu_torch.models.voxelnet_pm import (
    VoxelNetBranchPM,
    point_lidar_features,
)
from mvxnet_makise_tpu_torch.models.weights import load_jax_params
from mvxnet_makise_tpu_torch.train.step import frames_to_batch

CFG = Config(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
             voxel_shape=(32, 40, 10), image_size=(64, 96),
             max_points=1024, max_voxels=256, samples_per_voxel=8,
             assign_window=6)
TOL64 = dict(rtol=1e-8, atol=1e-8)
C_IN = 23


def _per_sample(fn, *xs):
    """Apply ``fn`` to batch-1 slices and stack the (tuple) results."""
    outs = [fn(*[x[i:i + 1] for x in xs]) for i in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate([np.asarray(o[k]) for o in outs])
                     for k in range(len(outs[0])))
    return np.concatenate([np.asarray(o) for o in outs])


@pytest.fixture(scope="module")
def data():
    """Voxelized frames, per-point 23-channel inputs and empty-slot rows,
    and one set of JAX branch weights loaded into the port's branch."""
    rng = np.random.default_rng(0)
    frames = [synthetic_frame(rng, CFG, num_cars=2, num_points=900)[:3]
              for _ in range(2)]
    pts, nums, imgs = native.assemble_batch(
        frames, CFG.velo_range, CFG.image_size, CFG.max_points, 2)
    b = frames_to_batch(torch.from_numpy(pts), torch.from_numpy(nums),
                        torch.from_numpy(imgs), CFG)
    B, P = b.sorted_kept.shape
    V = CFG.max_voxels
    x = rng.normal(size=(B, P, C_IN))
    z0 = np.broadcast_to(rng.normal(size=(B, 1, C_IN)), (B, V, C_IN)).copy()
    arrays = {k: getattr(b, k).numpy() for k in
              ("sorted_points", "sorted_kept", "sorted_seg", "counts",
               "coords", "vmask")}
    jax_branch = JaxBranch(CFG.voxel_shape, samples_per_voxel=8,
                           cml_mode="column")
    params = jax.jit(jax_branch.init)(
        jax.random.key(0), jnp.asarray(x[:1], jnp.float32),
        *[jnp.asarray(arrays[k][:1]) for k in
          ("sorted_kept", "sorted_seg", "counts", "coords", "vmask")],
        jnp.asarray(z0[:1], jnp.float32))
    params = jax.device_get(params)
    port = VoxelNetBranchPM(C_IN, CFG.voxel_shape, samples_per_voxel=8)
    load_jax_params(port, params)
    return dict(x=x, z0=z0, params=params, jax_branch=jax_branch,
                port=port.double().eval(), **arrays)


def _x64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_voxel_features(p, x, kept, seg, counts, vmask, z0):
    """The JAX branch's per-voxel features (VoxelNetBranchPM up to the
    CML), for one sample."""
    V = counts.shape[1]
    T = CFG.samples_per_voxel
    nv = jnp.clip(T - counts, 0, T).astype(x.dtype) * vmask
    h, z = JaxSVFE().apply({"params": p["svfe"]}, x, kept, seg, z0, nv,
                           vmask, V)
    h, hz = JaxDenseVW(128).apply({"params": p["fcn"]}, h, kept, z, nv,
                                  vmask)
    segmax = jax.vmap(lambda v, s, k: _segment_max(v, s, k, V))(h, seg,
                                                                 kept)
    vfeat = jnp.where((nv > 0)[..., None], jnp.maximum(segmax, hz), segmax)
    return jnp.where(vmask[..., None] & (vfeat > _NEG / 2), vfeat, 0.0)


def _torch(d, *names):
    return [torch.from_numpy(np.ascontiguousarray(d[n])) for n in names]


def test_point_lidar_features_match_jax(data):
    """Centroid offsets over each voxel's kept points (the port sums
    fixed windows of the sorted list; JAX a segment sum)."""
    d = data
    names = ("sorted_points", "sorted_seg", "sorted_kept", "counts")
    pts = d["sorted_points"].astype(np.float64)
    with jax.enable_x64(True):
        want = jax.vmap(jax_point_lidar_features)(
            jnp.asarray(pts), *[jnp.asarray(d[n]) for n in names[1:]])
    got = point_lidar_features(torch.from_numpy(pts),
                               *_torch(d, *names[1:]),
                               CFG.samples_per_voxel)
    assert got.shape == (2, CFG.max_points, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL64)


@torch.no_grad()
def test_vfe_stack_and_voxel_pooling_match_jax(data):
    d = data
    with jax.enable_x64(True):
        p = _x64(d["params"]["params"])
        want = _per_sample(
            lambda *a: _jax_voxel_features(p, *map(jnp.asarray, a)),
            d["x"], d["sorted_kept"], d["sorted_seg"], d["counts"],
            d["vmask"], d["z0"])
    x, kept, seg, counts, vmask, z0 = _torch(
        d, "x", "sorted_kept", "sorted_seg", "counts", "vmask", "z0")
    got = d["port"].voxel_features(x, kept, seg, counts, vmask, z0)
    assert got.shape == (2, CFG.max_voxels, 128)
    assert (got.abs().sum(-1) > 0).sum() > 50     # voxels carry features
    np.testing.assert_allclose(got.numpy(), want, **TOL64)


@pytest.mark.parametrize("precision", ["float64", "float32"])
@torch.no_grad()
def test_column_cml_matches_jax(data, precision):
    """conv1 (column compaction, tap matmul, K1), conv2 and conv3 with
    per-sample norms; float32 runs JAX's K1 as the Pallas kernel."""
    d = data
    rng = np.random.default_rng(1)
    vfeat = rng.normal(size=(2, CFG.max_voxels, 128)) * d["vmask"][..., None]
    p = d["params"]["params"]["cml"]
    args = (vfeat, d["coords"], d["vmask"])
    if precision == "float64":
        with jax.enable_x64(True):
            want = _per_sample(lambda *a: JaxCML(
                grid_shape=CFG.voxel_shape).apply(
                {"params": _x64(p)}, *map(jnp.asarray, a)), *args)
        cml, tol = d["port"].cml, TOL64
    else:
        vfeat = vfeat.astype(np.float32)
        want = _per_sample(lambda *a: JaxCML(
            grid_shape=CFG.voxel_shape).apply(
            {"params": p}, *map(jnp.asarray, a)),
            vfeat, d["coords"], d["vmask"])
        cml, tol = d["port"].cml.float(), dict(rtol=1e-4, atol=5e-4)
    got = cml(torch.from_numpy(vfeat), *_torch(d, "coords", "vmask"))
    d["port"].double()
    # the port's (B, C, D, nx, ny) against JAX's depth-minor (B, nx, ny,
    # D, C)
    np.testing.assert_allclose(got.permute(0, 3, 4, 2, 1).numpy(), want,
                               **tol)


@torch.no_grad()
def test_rpn_matches_jax(data):
    rng = np.random.default_rng(2)
    nx, ny, _ = CFG.voxel_shape
    x = rng.normal(size=(2, nx, ny, 128))
    tree = data["params"]["params"]["rpn"]
    with jax.enable_x64(True):
        want = _per_sample(lambda a: JaxRPN().apply(
            {"params": _x64(tree)}, jnp.asarray(a)), x)
    rpn = RPN(128)
    load_jax_params(rpn, tree)
    score, reg = rpn.double()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert score.shape == (2, nx // 2, ny // 2, 2)
    assert reg.shape == (2, nx // 2, ny // 2, 14)
    np.testing.assert_allclose(score.numpy(), want[0], **TOL64)
    np.testing.assert_allclose(reg.numpy(), want[1], **TOL64)


@torch.no_grad()
def test_whole_branch_matches_jax(data):
    """VFE, pooling, column CML, the (C, D) fold and the RPN."""
    d = data
    names = ("x", "sorted_kept", "sorted_seg", "counts", "coords", "vmask",
             "z0")
    with jax.enable_x64(True):
        p = _x64(d["params"])
        want = _per_sample(lambda *a: d["jax_branch"].apply(
            p, *map(jnp.asarray, a)), *[d[n] for n in names])
    score, reg = d["port"](*_torch(d, *names))
    np.testing.assert_allclose(score.numpy(), want[0], **TOL64)
    np.testing.assert_allclose(reg.numpy(), want[1], **TOL64)
