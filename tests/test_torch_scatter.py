"""PyTorch port: the dense voxel scatter (K4's plain version) and the
dense-3D CML against the JAX package.

``ops/scatter_grid.scatter_to_grid`` runs its plain version,
``ops/scatter.scatter_voxels_to_grid``, for CPU tensors (the card's
kernels are held against it in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``).  The same numpy voxel rows go through JAX's Pallas
kernel (interpret mode), its XLA scatter and its custom VJP
(``_pallas_scatter_diff``): values are copied, so forward and backward
agree exactly.  The dense CML (``MiddleConvLayers``: scatter, three 3-D
convolutions with per-sample norms) is held against JAX's in float64,
1e-8 (summation order only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.models.voxelnet import (
    MiddleConvLayers as JaxDenseCML,
)
from mvxnet_makise_tpu.models.voxelnet import _pallas_scatter_diff, _scatter
from mvxnet_makise_tpu.ops.pallas_scatter import pallas_scatter_to_grid
from mvxnet_makise_tpu.ops.scatter import (
    scatter_voxels_to_grid as jax_scatter,
)
from mvxnet_makise_tpu_torch.models.voxelnet import MiddleConvLayers
from mvxnet_makise_tpu_torch.ops.scatter import scatter_voxels_to_grid
from mvxnet_makise_tpu_torch.ops.scatter_grid import scatter_to_grid

GRID = (24, 40, 10)


def _voxels(seed, B=2, V=200, C=8, n_valid=(150, 0)):
    """Voxel rows at unique cells in the voxelizer's order (ascending
    linear id), invalid rows trailing with -1 coords; frame 1 empty."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = GRID
    coords = np.full((B, V, 3), -1, np.int32)
    mask = np.zeros((B, V), bool)
    for b, n in enumerate(n_valid):
        cells = np.sort(rng.choice(nx * ny * nz, n, replace=False))
        coords[b, :n] = np.stack([cells // (ny * nz), (cells // nz) % ny,
                                  cells % nz], -1)
        mask[b, :n] = True
    feats = rng.normal(size=(B, V, C)).astype(np.float32)
    return feats, coords, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_and_gradient_match_jax(seed):
    feats, coords, mask = _voxels(seed)
    g = np.random.default_rng(seed + 10).normal(
        size=(2, GRID[2], GRID[0], GRID[1], feats.shape[-1])
    ).astype(np.float32)
    tf = torch.from_numpy(feats).requires_grad_()
    got = scatter_to_grid(tf, torch.from_numpy(coords),
                          torch.from_numpy(mask), GRID)
    (got_d,) = torch.autograd.grad(got, tf, torch.from_numpy(g))
    assert got.shape == (2, GRID[2], GRID[0], GRID[1], 8)
    for b in range(2):
        args = (jnp.asarray(feats[b]), jnp.asarray(coords[b]),
                jnp.asarray(mask[b]))
        np.testing.assert_array_equal(
            got[b].detach().numpy(),
            np.asarray(pallas_scatter_to_grid(*args, GRID, interpret=True)))
        np.testing.assert_array_equal(got[b].detach().numpy(),
                                      np.asarray(jax_scatter(*args, GRID)))
        want, vjp = jax.vjp(lambda f: _pallas_scatter_diff(
            f, args[1], args[2], GRID), args[0])
        np.testing.assert_array_equal(got[b].detach().numpy(),
                                      np.asarray(want))
        np.testing.assert_array_equal(got_d[b].numpy(),
                                      np.asarray(vjp(jnp.asarray(g[b]))[0]))
    # every valid row landed, masked rows got no gradient
    assert int((got != 0).any(-1).sum()) == int(mask.sum())
    assert not got_d.numpy()[~mask].any()


def test_scatter_to_grid_refuses_other_devices():
    feats, coords, mask = _voxels(0)
    with pytest.raises(ValueError, match="device"):
        scatter_to_grid(*[torch.from_numpy(a).to("meta")
                          for a in (feats, coords, mask)], GRID)


def test_plain_scatter_is_the_wrappers_cpu_path():
    feats, coords, mask = map(torch.from_numpy, _voxels(2))
    assert torch.equal(scatter_to_grid(feats, coords, mask, GRID),
                       scatter_voxels_to_grid(feats, coords, mask, GRID))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@torch.no_grad()
def test_dense_cml_matches_jax(backend):
    """Scatter, conv1 (depth 10 -> 5), conv2 (5 -> 3), conv3 (3 -> 2),
    one sample at a time on the JAX side as norm_scope="sample" runs it."""
    feats, coords, mask = _voxels(3, C=128, n_valid=(150, 120))
    feats = feats.astype(np.float64) * mask[..., None]
    with jax.enable_x64(True):
        cml = JaxDenseCML()
        params = cml.init(jax.random.key(0), jnp.zeros(
            (1, GRID[2], GRID[0], GRID[1], 128)))
        want = []
        for b in range(2):
            dense = _scatter(jnp.asarray(feats[b]), jnp.asarray(coords[b]),
                             jnp.asarray(mask[b]), GRID, backend)
            want.append(np.asarray(cml.apply(params, dense[None]))[0])
    port = MiddleConvLayers(128, GRID, scatter_backend=backend).double()
    sd = {}
    for i in (1, 2, 3):
        tree = params["params"][f"conv{i}"]["conv"]
        sd[f"conv{i}.conv.weight"] = torch.from_numpy(np.transpose(
            np.asarray(tree["kernel"]), (4, 3, 0, 1, 2)).copy())
        sd[f"conv{i}.conv.bias"] = torch.from_numpy(np.array(tree["bias"]))
    port.load_state_dict(sd)
    got = port(torch.from_numpy(feats), torch.from_numpy(coords),
               torch.from_numpy(mask))
    assert got.shape == (2, 64, 2, GRID[0], GRID[1])
    # the port's (B, C, D, nx, ny) against JAX's (B, D, nx, ny, C)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.stack(want), rtol=1e-8, atol=1e-8)
