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


def _grid_coords(cells):
    """(ix, iy, iz) of grid cells numbered as the grid lays them out,
    iz * nx * ny + ix * ny + iy."""
    nx, ny, _ = GRID
    cells = np.asarray(cells)
    return np.stack([(cells // ny) % nx, cells % ny, cells // (nx * ny)],
                    -1).astype(np.int32)


def _shuffle(rng, feats, coords, mask):
    """Each frame's rows in a random order, masked rows among valid."""
    for b in range(len(mask)):
        p = rng.permutation(mask.shape[1])
        feats[b], coords[b], mask[b] = feats[b][p], coords[b][p], mask[b][p]
    return feats, coords, mask


def _case(case):
    """(features, coords, mask, dtype) of one parity case: seeds 0 and 1
    are ``_voxels``; the others are named for what they hold."""
    if case in (0, 1):
        return (*_voxels(case), torch.float32)
    rng = np.random.default_rng(100 + CASES.index(case))
    nx, ny, nz = GRID
    n_cells = nx * ny * nz
    if case == "shuffled":
        return (*_shuffle(rng, *_voxels(2, n_valid=(150, 90))),
                torch.float32)
    if case == "masked_on_valid":
        feats, coords, mask = _voxels(3, n_valid=(150, 120))
        for b in range(2):
            valid = np.flatnonzero(mask[b])
            coords[b, ~mask[b]] = coords[b, rng.choice(valid,
                                                       (~mask[b]).sum())]
        return (*_shuffle(rng, feats, coords, mask), torch.float32)
    if case == "edges":
        # the first and last cell, both sides of 256-cell and of JAX's
        # 8192-cell block boundaries; frame 1 holds only the last cell
        feats, coords, mask = _voxels(4, V=40, n_valid=(0, 0))
        edge = [0, 255, 256, 511, 512, 8191, 8192, n_cells - 1]
        coords[0, :len(edge)] = _grid_coords(edge)
        coords[1, 0] = _grid_coords([n_cells - 1])[0]
        mask[0, :len(edge)] = mask[1, 0] = True
        return (*_shuffle(rng, feats, coords, mask), torch.float32)
    if case == "all_valid_and_all_masked":
        # frame 0: every row valid; frame 1: every row masked, its coords
        # naming real cells
        V = 300
        coords = np.stack([_grid_coords(rng.choice(n_cells, V,
                                                   replace=False))
                           for _ in range(2)])
        mask = np.array([[True] * V, [False] * V])
        feats = rng.normal(size=(2, V, 8)).astype(np.float32)
        return feats, coords, mask, torch.float32
    assert case == "bfloat16"
    return (*_shuffle(rng, *_voxels(5, n_valid=(150, 60))), torch.bfloat16)


CASES = [0, 1, "shuffled", "masked_on_valid", "edges",
         "all_valid_and_all_masked", "bfloat16"]


@pytest.mark.parametrize("case", CASES)
def test_scatter_and_gradient_match_jax(case):
    """The port's scatter and its gradient against JAX's Pallas kernel
    (interpret mode), its XLA scatter and ``_pallas_scatter_diff``'s VJP:
    copies, so exact, in every row order and dtype."""
    feats, coords, mask, dtype = _case(case)
    B, _, C = feats.shape
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    tf = torch.from_numpy(feats).to(dtype).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(10 + CASES.index(case))
                         .normal(size=(B, GRID[2], GRID[0], GRID[1], C))
                         .astype(np.float32)).to(dtype)
    got = scatter_to_grid(tf, torch.from_numpy(coords),
                          torch.from_numpy(mask), GRID)
    (got_d,) = torch.autograd.grad(got, tf, g)
    assert got.shape == (B, GRID[2], GRID[0], GRID[1], C)
    assert got.dtype == got_d.dtype == dtype
    got_np, got_d_np = got.detach().float().numpy(), got_d.float().numpy()
    for b in range(B):
        args = (jnp.asarray(tf[b].detach().float().numpy(), jdtype),
                jnp.asarray(coords[b]), jnp.asarray(mask[b]))
        np.testing.assert_array_equal(got_np[b], np.asarray(
            pallas_scatter_to_grid(*args, GRID, interpret=True),
            np.float32))
        np.testing.assert_array_equal(
            got_np[b], np.asarray(jax_scatter(*args, GRID), np.float32))
        want, vjp = jax.vjp(lambda f: _pallas_scatter_diff(
            f, args[1], args[2], GRID), args[0])
        np.testing.assert_array_equal(got_np[b],
                                      np.asarray(want, np.float32))
        (want_d,) = vjp(jnp.asarray(g[b].float().numpy(), jdtype))
        np.testing.assert_array_equal(got_d_np[b],
                                      np.asarray(want_d, np.float32))
    # every valid row landed, masked rows got no gradient
    assert int((got != 0).any(-1).sum()) == int(mask.sum())
    assert not got_d_np[~mask].any()


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
