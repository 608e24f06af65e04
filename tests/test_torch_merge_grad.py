"""PyTorch port: the gradients of K1 and K3 against the JAX package.

On CPU tensors the wrappers run the plain versions, and their gradients
are autograd through the same PyTorch ops; the card's backward kernels
are held against these in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.  Here the same numpy inputs and cotangents go through
``jax.vjp`` of JAX's custom-VJP functions:

* K1 (``merge_taps_fused``): dy and dbias against ``_merge_fused_bwd``,
  float64 on both sides (``backend="xla"``, under ``jax.enable_x64``),
  1e-12 (summation order only);
* K3 (``merge_taps``): forward and backward against the Pallas kernel
  (interpret mode) and the XLA composition, float32, 1e-5 (the backward
  is a gather: exact).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.ops.pallas_column_merge import (
    merge_taps as jax_merge_taps,
)
from mvxnet_makise_tpu.ops.pallas_column_merge import (
    merge_taps_fused as jax_merge_taps_fused,
)
from mvxnet_makise_tpu_torch.ops import column_merge

GRID = (16, 24, 10)
R = 6                # d_out * Cout stand-in, unaligned on purpose


def _columns(seed, B=2, V=96, empty_frame=None):
    """Sorted active BEV columns (one whole BEV row filled, so many
    columns share a row; columns on the grid's edges), dead slots with
    nonzero rows, numpy (y, col_cy, bounds, bias, g_out, g_stats)."""
    rng = np.random.default_rng(seed)
    nx, ny, _ = GRID
    col_cy = np.zeros((B, V), np.int32)
    bounds = np.zeros((B, nx + 1), np.int32)
    for b in range(B):
        if b == empty_frame:
            continue
        n = int(rng.integers(V // 2, V - 8))
        cells = rng.choice(nx * ny, n, replace=False)
        row = rng.integers(0, nx)
        cells = np.unique(np.concatenate(
            [row * ny + np.arange(ny), [0, nx * ny - 1], cells]))[:V]
        col_cy[b, :len(cells)] = cells % ny
        bounds[b] = np.searchsorted(cells // ny, np.arange(nx + 1))
    y = rng.normal(size=(B, V, 9, R))
    # a zero bias lane puts exact zeros at empty cells: ReLU must pass no
    # gradient there
    bias = np.concatenate([[0.0], rng.normal(size=R - 1)])
    g_out = rng.normal(size=(B, nx, ny, R))
    g_stats = rng.normal(size=(B, nx, 2, R)) * 0.1
    return y, col_cy, bounds, bias, g_out, g_stats


@pytest.mark.parametrize("case", [dict(seed=0), dict(seed=1, empty_frame=0)])
def test_fused_merge_gradients_match_jax(case):
    y, col_cy, bounds, bias, g_out, g_stats = _columns(**case)
    with jax.enable_x64(True):
        (want_out, want_stats), vjp = jax.vjp(
            lambda a, c: jax_merge_taps_fused(
                a, jnp.asarray(col_cy), jnp.asarray(bounds), c, GRID, "xla"),
            jnp.asarray(y), jnp.asarray(bias))
        want_dy, want_dbias = vjp((jnp.asarray(g_out), jnp.asarray(g_stats)))
    ty = torch.from_numpy(y).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out, stats = column_merge.merge_taps_fused(
        ty, torch.from_numpy(col_cy), torch.from_numpy(bounds), tb, GRID)
    dy, dbias = torch.autograd.grad((out, stats), (ty, tb),
                                    (torch.from_numpy(g_out),
                                     torch.from_numpy(g_stats)))
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **tol)
    np.testing.assert_allclose(stats.detach().numpy(),
                               np.asarray(want_stats), **tol)
    np.testing.assert_allclose(dy.numpy(), np.asarray(want_dy), **tol)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want_dbias), **tol)
    # dead slots get no gradient
    live = np.arange(y.shape[1])[None] < bounds[:, -1:]
    assert not dy.numpy()[~live].any()


@pytest.mark.parametrize("case", [dict(seed=2), dict(seed=3, empty_frame=1)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_merge_taps_and_gradient_match_jax(case, backend):
    y, col_cy, bounds, _, g_out, _ = [
        a.astype(np.float32) if a.dtype == np.float64 else a
        for a in _columns(**case)]
    want, vjp = jax.vjp(lambda a: jax_merge_taps(
        a, jnp.asarray(col_cy), jnp.asarray(bounds), GRID, backend),
        jnp.asarray(y))
    (want_dy,) = vjp(jnp.asarray(g_out))
    ty = torch.from_numpy(y).requires_grad_()
    out = column_merge.merge_taps(ty, torch.from_numpy(col_cy),
                                  torch.from_numpy(bounds), GRID)
    (dy,) = torch.autograd.grad(out, ty, torch.from_numpy(g_out))
    assert out.shape == (2, GRID[0], GRID[1], R) and out.dtype == ty.dtype
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dy.numpy(), np.asarray(want_dy))


def test_merge_taps_refuses_other_devices():
    y, col_cy, bounds, *_ = _columns(0)
    with pytest.raises(ValueError, match="device"):
        column_merge.merge_taps(
            *[torch.from_numpy(a).float().to("meta") if a.dtype == np.float64
              else torch.from_numpy(a).to("meta") for a in (y, col_cy,
                                                           bounds)], GRID)
