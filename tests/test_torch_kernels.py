"""PyTorch port: the two kernels' wrappers against the JAX package.

K1 (``ops/column_merge.merge_taps_fused``) and K2
(``ops/gather.fpn_gather``) take their plain PyTorch versions for CPU
tensors, so here the plain versions meet the Pallas kernels (interpret
mode, as the JAX package's own tests run them) and the XLA compositions,
on the same numpy inputs.  Tolerances: float32 on both sides, only the
order of the sums differs — 1e-5 relative / 1e-5 absolute.

``test_torch_gpu.py`` holds the CUDA kernels against these plain versions
on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvxnet_makise_tpu.ops.column_conv import (
    compact_columns as jax_compact_columns,
)
from mvxnet_makise_tpu.ops.gather import bilinear_gather_fpn_batch
from mvxnet_makise_tpu.ops.pallas_column_merge import (
    column_bounds as jax_column_bounds,
)
from mvxnet_makise_tpu.ops.pallas_column_merge import (
    merge_taps_fused as jax_merge_taps_fused,
)
from mvxnet_makise_tpu.ops.pallas_gather import fpn_gather_banded
from mvxnet_makise_tpu_torch.ops import column_merge, gather
from mvxnet_makise_tpu_torch.ops.column_conv import compact_columns

TOL = dict(rtol=1e-5, atol=1e-5)
GRID = (16, 24, 10)
R = 2 * 3            # d_out * Cout stand-in, unaligned on purpose
IMG = (37, 122)
LEVELS = [(16, 24, 8), (8, 12, 8), (4, 6, 8)]


# --------------------------------------------------------------------- K1

def _columns(seed, B=2, V=64, dense_row=False, empty_frame=None):
    """Random sorted active BEV columns per frame -> numpy (y, col_cy,
    bounds, bias).  ``dense_row`` fills one whole BEV row (many columns
    per row); ``empty_frame`` gives that frame no active column."""
    rng = np.random.default_rng(seed)
    nx, ny, _ = GRID
    col_cy = np.zeros((B, V), np.int32)
    bounds = np.zeros((B, nx + 1), np.int32)
    for b in range(B):
        n = 0 if b == empty_frame else int(rng.integers(V // 2, V + 1))
        cells = rng.choice(nx * ny, n, replace=False)
        if dense_row and n:
            row = rng.integers(0, nx)
            cells = np.unique(np.concatenate(
                [row * ny + np.arange(ny), cells]))[:V]
            n = len(cells)
        cells = np.sort(cells)
        col_cy[b, :n] = cells % ny
        bounds[b] = np.searchsorted(cells // ny, np.arange(nx + 1),
                                    side="left")
    # dead slots carry nonzero rows: they must not contribute
    y = rng.normal(size=(B, V, 9, R)).astype(np.float32)
    bias = rng.normal(size=(R,)).astype(np.float32)
    return y, col_cy, bounds, bias


@pytest.mark.parametrize("case", [
    dict(seed=0), dict(seed=1, V=96, dense_row=True),
    dict(seed=2, empty_frame=1)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_merge_taps_fused_matches_jax(case, backend):
    y, col_cy, bounds, bias = _columns(**case)
    want_out, want_stats = jax_merge_taps_fused(
        jnp.asarray(y), jnp.asarray(col_cy), jnp.asarray(bounds),
        jnp.asarray(bias), GRID, backend)
    got_out, got_stats = column_merge.merge_taps_fused(
        *map(torch.from_numpy, (y, col_cy, bounds, bias)), GRID)
    assert got_out.shape == (2, GRID[0], GRID[1], R)
    assert got_stats.shape == (2, GRID[0], 2, R)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_stats.numpy(), np.asarray(want_stats),
                               **TOL)
    if "empty_frame" in case:
        # an empty frame is relu(bias) everywhere
        np.testing.assert_array_equal(
            got_out[1].numpy(),
            np.broadcast_to(np.maximum(bias, 0), got_out[1].shape))


def test_merge_taps_fused_bf16_rounds_once_as_the_pallas_kernel():
    """bfloat16 K1: the Pallas kernel adds the bias to its float32 tap sum
    and rounds once; JAX's XLA reference rounds the sum to bfloat16 first.
    The plain version's ``accumulate=torch.float32`` option (the card
    kernel's reference) follows the first, its default the second.  Every
    value is k/64 with |k| <= 255, so each float32 sum is exact and only
    the rounding to bfloat16 can differ: bit-equal both ways, and the two
    references differ somewhere."""
    y, col_cy, bounds, _ = _columns(5, V=96, dense_row=True)
    rng = np.random.default_rng(5)
    y = (rng.integers(-255, 256, y.shape) / 64).astype(np.float32)
    bias = (rng.integers(-255, 256, (R,)) / 64).astype(np.float32)
    jy = jnp.asarray(y, jnp.bfloat16)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jy, np.float32), ty.float().numpy())
    args = (jnp.asarray(col_cy), jnp.asarray(bounds), jnp.asarray(bias),
            GRID)
    targs = (*map(torch.from_numpy, (col_cy, bounds, bias)), GRID)
    once_out, once_stats = column_merge.merge_taps_fused_plain(
        ty, *targs, accumulate=torch.float32)
    twice_out, twice_stats = column_merge.merge_taps_fused_plain(ty, *targs)
    for backend, out, stats in (("pallas", once_out, once_stats),
                                ("xla", twice_out, twice_stats)):
        want_out, want_stats = jax_merge_taps_fused(jy, *args, backend)
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(want_out, np.float32))
        np.testing.assert_allclose(stats.numpy(), np.asarray(want_stats),
                                   **TOL)
    assert not torch.equal(once_out, twice_out)


def test_column_bounds_match_jax():
    rng = np.random.default_rng(4)
    nx, ny, nz = GRID
    B, V = 2, 80
    coords = np.full((B, V, 3), -1, np.int32)
    vmask = np.zeros((B, V), bool)
    for b, n in enumerate((70, 0)):
        cells = np.sort(rng.choice(nx * ny * nz, n, replace=False))
        coords[b, :n] = np.stack([cells // (ny * nz), (cells // nz) % ny,
                                  cells % nz], -1)
        vmask[b, :n] = True
    vfeat = rng.normal(size=(B, V, 5)).astype(np.float32)
    _, col_xy, col_mask = compact_columns(
        torch.from_numpy(vfeat), torch.from_numpy(coords),
        torch.from_numpy(vmask), GRID)
    got = column_merge.column_bounds(col_xy, col_mask, nx)
    for b in range(B):
        _, jxy, jmask = jax_compact_columns(
            jnp.asarray(vfeat[b]), jnp.asarray(coords[b]),
            jnp.asarray(vmask[b]), GRID, assume_sorted=True)
        np.testing.assert_array_equal(col_xy[b].numpy(), np.asarray(jxy))
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jax_column_bounds(jxy, jmask, nx)))


def test_merge_taps_fused_refuses_other_devices():
    y, col_cy, bounds, bias = _columns(0)
    args = [torch.from_numpy(a).to("meta") for a in (y, col_cy, bounds,
                                                      bias)]
    with pytest.raises(ValueError, match="device"):
        column_merge.merge_taps_fused(*args, GRID)


# --------------------------------------------------------------------- K2

def _gather_inputs(seed, B=2, P=64, clustered=False, none_valid=False):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, *s)).astype(np.float32) for s in LEVELS]
    if clustered:
        r = rng.choice([3.0, 3.5, 30.0], (B, P), p=[0.5, 0.4, 0.1])
        r = r + rng.uniform(0, 0.4, (B, P))
    else:
        r = rng.uniform(0, IMG[0], (B, P))
    # a few points exactly on the image's far edges (clamped taps)
    c = rng.uniform(0, IMG[1], (B, P))
    r[:, :3], c[:, 3:6] = IMG[0], IMG[1]
    rc = np.stack([r, c], -1).astype(np.float32)
    ok = rng.random((B, P)) < 0.8
    if none_valid:
        ok[1] = False
    return feats, rc, ok


@pytest.mark.parametrize("case", [
    dict(seed=0), dict(seed=1, clustered=True),
    dict(seed=2, none_valid=True)])
@pytest.mark.parametrize("swapped", [False, True])
def test_fpn_gather_matches_jax(case, swapped):
    feats, rc, ok = _gather_inputs(**case)
    got = gather.fpn_gather([torch.from_numpy(f) for f in feats],
                            torch.from_numpy(rc), torch.from_numpy(ok), IMG,
                            swapped_weights=swapped).numpy()
    want = np.asarray(bilinear_gather_fpn_batch(
        [jnp.asarray(f) for f in feats], jnp.asarray(rc), jnp.asarray(ok),
        IMG, swapped_weights=swapped))
    banded, pos, _ = fpn_gather_banded(
        [jnp.asarray(f) for f in feats], jnp.asarray(rc), jnp.asarray(ok),
        IMG, swapped_weights=swapped, window=8, interpret=True)
    # the Pallas kernel emits band order; pos maps it back to point order
    pallas = np.take_along_axis(np.asarray(banded),
                                np.asarray(pos)[..., None], axis=1)
    assert got.shape == (2, 64, 24)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    assert not got[~ok].any()


def test_fpn_gather_refuses_other_devices():
    feats, rc, ok = _gather_inputs(0)
    with pytest.raises(ValueError, match="device"):
        gather.fpn_gather([torch.from_numpy(f).to("meta") for f in feats],
                          torch.from_numpy(rc).to("meta"),
                          torch.from_numpy(ok).to("meta"), IMG)
