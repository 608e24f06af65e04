"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and ``Detector`` on ``cuda`` against the same weights on the CPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerances: K1 and K3 sum the same taps in the same order as their plain
versions: K1's output equals its plain version summed in float32 and
rounded once (in bfloat16 ``accumulate=torch.float32``) exactly, its row
statistics within 1e-5 (float32 sums in another order); K3 within 1e-5 in
float32, or exact where a test says so (bfloat16 2e-2); K2
rounds its four weighted taps in another order (1e-5).  K2 in bfloat16
sums in float32 and rounds once, where its plain version rounds each of
its 11 products and sums to bfloat16 (each rounding at most 2^-9 of the
largest level value): 2^-5 of that value; against the float32 sum of
its own formula, one bfloat16 step.  K1's backward
forms the pre-ReLU cotangent with its adds in another order than
autograd (1e-5) and sums the bias gradient over every cell in another
order (1e-4 of the largest value).  K4 and K3's backward copy values:
exact.  The batched decode and NMS on the card pick the CPU's boxes
(indices, valid, classes, scores exact); the decoded boxes sit within
1e-5 (float32 exp, sin and cos may round one ulp apart).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.eval.decode import decode_batch
from mvxnet_makise_tpu_torch.geometry.boxes import decode_boxes
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.voxelnet import RPN
from mvxnet_makise_tpu_torch.ops import column_merge, gather, scatter_grid
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.ops.nms import rotated_nms_bev_batch
from mvxnet_makise_tpu_torch.ops.scatter import scatter_voxels_to_grid
from mvxnet_makise_tpu_torch.serve import Detector
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.loop import (
    collate,
    preprocess_train_frame,
)
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    frames_to_batch,
    make_train_step,
    model_inputs,
)

pytestmark = pytest.mark.gpu

GRID = (24, 40, 10)
IMG = (37, 122)
TINY = Config(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
              voxel_shape=(32, 40, 10), image_size=(64, 96),
              max_points=1024, max_voxels=256, samples_per_voxel=8,
              assign_window=6, image_min_side=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _columns(seed, R, B=2, V=160, grid=GRID):
    """Sorted active BEV columns: frame 0 empty, frame 1 with one whole
    BEV row filled (many columns per row), columns on all four grid
    borders and corners, and random cells; the slots past the last column
    are dead and carry nonzero rows."""
    rng = np.random.default_rng(seed)
    nx, ny, _ = grid
    col_cy = np.zeros((B, V), np.int32)
    bounds = np.zeros((B, nx + 1), np.int32)
    mid_x, mid_y = nx // 2, ny // 2
    border = np.array([0, ny - 1, (nx - 1) * ny, nx * ny - 1,
                       mid_y, (nx - 1) * ny + mid_y, mid_x * ny,
                       mid_x * ny + ny - 1])
    for b in range(1, B):
        cells = rng.choice(nx * ny, min(V // 2, nx * ny), replace=False)
        cells = np.unique(np.concatenate(
            [rng.integers(0, nx) * ny + np.arange(ny), border, cells]))
        assert len(cells) <= V - 8
        col_cy[b, :len(cells)] = cells % ny
        bounds[b] = np.searchsorted(cells // ny, np.arange(nx + 1))
    y = rng.normal(size=(B, V, 9, R)).astype(np.float32)
    bias = rng.normal(size=(R,)).astype(np.float32)
    return y, col_cy, bounds, bias


def _merge_reference(y, col_cy, bounds, bias, grid):
    """K1's plain version as the kernel computes it: in bfloat16 the float32
    tap sum plus the bias, rounded once (``accumulate=torch.float32``)."""
    acc = torch.float32 if y.dtype == torch.bfloat16 else None
    return column_merge.merge_taps_fused_plain(y, col_cy, bounds, bias,
                                               grid, accumulate=acc)


def _assert_stats_close(stats, want):
    """Row statistics: float32 sums of the same values in another order,
    1e-5 of the largest value."""
    scale = max(1.0, float(want.detach().abs().max()))
    assert float((stats - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("R", [6, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_kernel_matches_plain(cuda, R, dtype):
    y, col_cy, bounds, bias = [torch.from_numpy(a).to(cuda)
                               for a in _columns(0, R)]
    y = y.to(dtype)
    before = column_merge.KERNEL.launches
    out, stats = column_merge.merge_taps_fused(y, col_cy, bounds, bias,
                                               GRID)
    assert column_merge.KERNEL.launches == before + 1
    want_out, want_stats = _merge_reference(y, col_cy, bounds, bias, GRID)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out)
    _assert_stats_close(stats, want_stats)
    if dtype == torch.float32:
        torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-4)
    # the empty frame is relu(bias) everywhere
    torch.testing.assert_close(
        out[0].float(), torch.relu(bias).to(dtype).float().expand(
            *GRID[:2], R), rtol=0, atol=0)
    # the row statistics are summed in a fixed order: the same bits twice
    out2, stats2 = column_merge.merge_taps_fused(y, col_cy, bounds, bias,
                                                 GRID)
    assert torch.equal(out2, out) and torch.equal(stats2, stats)


# grids whose ny is no multiple of the forward's oy tile (ny / 4 rounded
# up), of its cell groups nor of the backward first pass's segments and
# cell groups, a full-width row of 400 cells, and a row narrower than the
# four tiles
EDGE_GRIDS = [(8, 37, 10), (4, 400, 10), (5, 3, 10), (3, 251, 10)]


def _misaligned(t):
    """The same values one element into a fresh buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    t = buf[1:].view(t.shape)
    assert t.data_ptr() % 16 and t.is_contiguous()
    return t


@pytest.mark.parametrize("grid", EDGE_GRIDS)
@pytest.mark.parametrize("R", [6, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("misaligned", [False, True])
def test_merge_kernels_edge_shapes(cuda, grid, R, dtype, misaligned):
    """K1, K3 and K3's backward on edge shapes, on the vector path (R =
    320, 16-byte rows) and the scalar one (R = 6, or any y that does not
    start on a 16-byte boundary).  K1's output is bit-equal to its plain
    version summed in float32 and rounded once (in float32 the default
    plain version; in bfloat16 ``accumulate=torch.float32``) and the row
    statistics within 1e-5; K3 adds and rounds as its plain version does
    in both types, and its backward copies: exact."""
    V = grid[0] * grid[1] + 16
    y, col_cy, bounds, bias = [torch.from_numpy(a).to(cuda) for a in
                               _columns(7, R, V=V, grid=grid)]
    y = y.to(dtype)
    if misaligned:
        y = _misaligned(y)
    y.requires_grad_()
    out, stats = column_merge.merge_taps_fused(y, col_cy, bounds, bias, grid)
    out2, stats2 = column_merge.merge_taps_fused(y, col_cy, bounds, bias,
                                                 grid)
    want_out, want_stats = _merge_reference(y, col_cy, bounds, bias, grid)
    merged = column_merge.merge_taps(y, col_cy, bounds, grid)
    want_merged = column_merge.merge_taps_plain(y, col_cy, bounds, grid)
    g = torch.randn(merged.shape, generator=torch.Generator().manual_seed(1)
                    ).to(cuda, dtype)
    (dy,) = torch.autograd.grad(merged, y, g)
    (want_dy,) = torch.autograd.grad(want_merged, y, g)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out)
    _assert_stats_close(stats, want_stats)
    assert torch.equal(out2, out) and torch.equal(stats2, stats)
    assert torch.equal(merged, want_merged)
    assert torch.equal(dy, want_dy)
    # dead slots get no gradient
    live = torch.arange(V, device=cuda)[None] < bounds[:, -1:]
    assert not dy[~live].any() and dy[live].any()


def test_merge_kernel_refuses_what_it_does_not_take(cuda):
    y, col_cy, bounds, bias = [torch.from_numpy(a).to(cuda)
                               for a in _columns(1, 8)]
    with pytest.raises(ValueError, match="contiguous"):
        column_merge.merge_taps_fused(y.transpose(0, 1).contiguous()
                                      .transpose(0, 1), col_cy, bounds,
                                      bias, GRID)
    with pytest.raises(ValueError, match="bounds"):
        column_merge.merge_taps_fused(y, col_cy, bounds.long(), bias, GRID)
    with pytest.raises(TypeError):
        column_merge.merge_taps_fused(y.half(), col_cy, bounds, bias, GRID)


def _merge_backward_inputs(cuda, R, dtype, seed=2):
    y, col_cy, bounds, bias = [torch.from_numpy(a).to(cuda)
                               for a in _columns(seed, R)]
    y = y.to(dtype).requires_grad_()
    bias = bias.requires_grad_()
    g = torch.Generator().manual_seed(seed)
    g_out = torch.randn((2, *GRID[:2], R), generator=g).to(cuda, dtype)
    g_stats = torch.randn((2, GRID[0], 2, R), generator=g).to(cuda) * 0.1
    return y, col_cy, bounds, bias, g_out, g_stats


@pytest.mark.parametrize("R", [6, 320])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_merge_backward_kernel_matches_plain(cuda, R, dtype, tol):
    """K1's backward (pre and dbias kernels, then K3's gather) against
    ``_merge_fused_bwd``'s formula on the kernel's own output, with dy by
    autograd through the plain merge; in float32 also against autograd
    through the whole plain version.  (In bfloat16 the kernel adds the bias
    to the float32 sum and the plain version to the sum rounded to
    bfloat16, so a cell near 0 can change sign, and with it the ReLU
    mask.)"""
    y, col_cy, bounds, bias, g_out, g_stats = _merge_backward_inputs(
        cuda, R, dtype)
    counts = [k.launches for k in column_merge.KERNELS]
    out, stats = column_merge.merge_taps_fused(y, col_cy, bounds, bias, GRID)
    dy, dbias = torch.autograd.grad((out, stats), (y, bias),
                                    (g_out, g_stats))
    assert [k.launches - c for k, c in
            zip(column_merge.KERNELS, counts)] == [1, 1, 0, 1]
    assert dy.dtype == dtype and dbias.dtype == torch.float32
    o = out.detach().float()
    pre = ((g_out.float() + g_stats[:, :, 0, None].to(dtype).float()
            + 2 * o * g_stats[:, :, 1, None].to(dtype).float())
           * (o > 0)).to(dtype)
    wants = [(torch.autograd.grad(column_merge.merge_taps_plain(
        y, col_cy, bounds, GRID), y, pre)[0], pre.float().sum((0, 1, 2)))]
    if dtype == torch.float32:
        want_out, want_stats = column_merge.merge_taps_fused_plain(
            y, col_cy, bounds, bias, GRID)
        wants.append(torch.autograd.grad((want_out, want_stats), (y, bias),
                                         (g_out, g_stats)))
    torch.cuda.synchronize()
    for want_dy, want_dbias in wants:
        torch.testing.assert_close(dy.float(), want_dy.float(), rtol=tol,
                                   atol=tol)
        scale = max(1.0, float(want_dbias.abs().max()))
        assert float((dbias - want_dbias).abs().max()) <= 10 * tol * scale
    # no atomics: the same cotangents give the same bits
    dy2, dbias2 = column_merge.merge_taps_fused_backward(
        out.detach(), g_out, g_stats, col_cy, bounds, y.shape[1], GRID)
    assert torch.equal(dy2, dy) and torch.equal(dbias2, dbias)


@pytest.mark.parametrize("grid", EDGE_GRIDS)
@pytest.mark.parametrize("R", [6, 320])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_merge_backward_edge_shapes(cuda, grid, R, dtype, tol, misaligned,
                                    B):
    """K1 backward's first pass on the edge grids and on a batch of one
    frame, on the vector path (R = 320) and the scalar one (R = 6, or an
    out that does not start on a 16-byte boundary): pre within a rounding
    of ``_merge_fused_bwd``'s formula on K1's output (the kernel may fuse a
    multiply-add), dy exactly K3's plain gather of that pre, dbias within
    1e-5 of the float32 sum of that pre (another order), and pre and dbias
    the same bits twice."""
    V = grid[0] * grid[1] + 16
    y, col_cy, bounds, bias = [torch.from_numpy(a).to(cuda) for a in
                               _columns(11, R, V=V, grid=grid)]
    if B == 1:
        # the frame with columns (frame 0 is empty)
        y, col_cy, bounds = y[1:], col_cy[1:], bounds[1:]
    out, stats = column_merge.merge_taps_fused(y.to(dtype), col_cy, bounds,
                                               bias, grid)
    gen = torch.Generator().manual_seed(12)
    g_out = torch.randn(out.shape, generator=gen).to(cuda, dtype)
    g_stats = torch.randn(stats.shape, generator=gen).to(cuda) * 0.1
    if misaligned:
        out, g_out = _misaligned(out), _misaligned(g_out)
    before = column_merge.BWD_KERNEL.launches
    pre, dbias = column_merge.merge_fused_pre(out, g_out, g_stats)
    assert column_merge.BWD_KERNEL.launches == before + 1
    vec = 16 // out.element_size()
    vector = (R * out.element_size()) % 16 == 0 and not misaligned
    block = column_merge.BWD_KERNEL.last_launch[0]["block"]
    assert block[0] == min(R // vec if vector else R, 320)
    pre2, dbias2 = column_merge.merge_fused_pre(out, g_out, g_stats)
    dy, dbias3 = column_merge.merge_taps_fused_backward(
        out, g_out, g_stats, col_cy, bounds, V, grid)
    o = out.float()
    want_pre = ((g_out.float() + g_stats[:, :, 0, None].to(dtype).float()
                 + 2 * o * g_stats[:, :, 1, None].to(dtype).float())
                * (o > 0)).to(dtype)
    yp = y.to(dtype).requires_grad_()
    (want_dy,) = torch.autograd.grad(column_merge.merge_taps_plain(
        yp, col_cy, bounds, grid), yp, pre)
    torch.cuda.synchronize()
    torch.testing.assert_close(pre.float(), want_pre.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(dy, want_dy)
    want_dbias = pre.float().sum((0, 1, 2))
    scale = max(1.0, float(want_dbias.abs().max()))
    assert float((dbias - want_dbias).abs().max()) <= 1e-5 * scale
    assert torch.equal(pre2, pre) and torch.equal(dbias2, dbias)
    assert torch.equal(dbias3, dbias)


@pytest.mark.parametrize("R", [6, 320])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_merge_taps_kernel_matches_plain(cuda, R, dtype, tol):
    """K3 forward (K1's kernel without its epilogue) and backward."""
    y, col_cy, bounds, _, g_out, _ = _merge_backward_inputs(cuda, R, dtype,
                                                            seed=3)
    before = (column_merge.TAPS_KERNEL.launches,
              column_merge.TAPS_BWD_KERNEL.launches)
    out = column_merge.merge_taps(y, col_cy, bounds, GRID)
    (dy,) = torch.autograd.grad(out, y, g_out)
    assert (column_merge.TAPS_KERNEL.launches,
            column_merge.TAPS_BWD_KERNEL.launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = column_merge.merge_taps_plain(y, col_cy, bounds, GRID)
    (want_dy,) = torch.autograd.grad(want, y, g_out)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(dy, want_dy, rtol=0, atol=0)
    # the empty frame merges to 0
    assert not out[0].any()


def _voxels(seed, C, dtype, B=2, V=300, grid=(24, 40, 10)):
    """Voxel rows at unique random cells, unsorted, a third masked off
    (their coords point at real cells that must stay 0)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = grid
    coords = np.zeros((B, V, 3), np.int32)
    for b in range(B):
        cells = rng.choice(nx * ny * nz, V, replace=False)
        coords[b] = np.stack([(cells // ny) % nx, cells % ny,
                              cells // (nx * ny)], -1)
    mask = rng.random((B, V)) < 0.67
    feats = torch.from_numpy(rng.normal(size=(B, V, C)).astype(np.float32))
    return feats.to(dtype), torch.from_numpy(coords), torch.from_numpy(mask)


@pytest.mark.parametrize("C,dtype", [(128, torch.float32),
                                     (8, torch.bfloat16)])
def test_scatter_grid_kernel_matches_plain(cuda, C, dtype):
    grid = (24, 40, 10)
    feats, coords, mask = [t.to(cuda) for t in _voxels(4, C, dtype)]
    feats.requires_grad_()
    before = (scatter_grid.KERNEL.launches, scatter_grid.BWD_KERNEL.launches)
    got = scatter_grid.scatter_to_grid(feats, coords, mask, grid)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(0)
                    ).to(cuda, dtype)
    (d,) = torch.autograd.grad(got, feats, g)
    assert (scatter_grid.KERNEL.launches,
            scatter_grid.BWD_KERNEL.launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = scatter_voxels_to_grid(feats, coords, mask, grid)
    (want_d,) = torch.autograd.grad(want, feats, g)
    torch.cuda.synchronize()
    assert got.shape == (2, 10, 24, 40, C)
    assert torch.equal(got, want) and torch.equal(d, want_d)
    assert int((got != 0).any(-1).sum()) == int(mask.sum())


def _k4_case(case, grid=(24, 40, 10)):
    """(features, coords, mask) of one K4 case on the CPU, B = 2, C = 8:
    "sorted" (the voxelizer's ascending (ix, iy, iz) order, masked rows
    trailing with -1 coords), "shuffled", "masked_on_valid" (masked rows
    whose coords name valid rows' cells), "edges" (the first and the last
    cell, both sides of 256-cell boundaries: a float32 row of 8 channels
    is 32 bytes, so 256 cells fill one 8 KB block of the fill kernel),
    "all_valid_and_all_masked" (frame 0 every row valid, frame 1 every row
    masked at real cells), "bfloat16" (shuffled, bfloat16 rows)."""
    rng = np.random.default_rng(["sorted", "shuffled", "masked_on_valid",
                                 "edges", "all_valid_and_all_masked",
                                 "bfloat16"].index(case))
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    B, V, C = 2, 200, 8

    def at(cells):
        cells = np.asarray(cells)
        return np.stack([(cells // ny) % nx, cells % ny,
                         cells // (nx * ny)], -1)

    coords = np.full((B, V, 3), -1, np.int32)
    mask = np.zeros((B, V), bool)
    n_valid = (150, 90)
    if case == "edges":
        edge = [0, 255, 256, 511, 512, 8191, 8192, n_cells - 1]
        coords[0, :len(edge)] = at(edge)
        coords[1, 0] = at([n_cells - 1])[0]
        mask[0, :len(edge)] = mask[1, 0] = True
    elif case == "all_valid_and_all_masked":
        for b in range(B):
            coords[b] = at(rng.choice(n_cells, V, replace=False))
        mask[0] = True
    else:
        for b, n in enumerate(n_valid):
            cells = np.sort(rng.choice(n_cells, n, replace=False))
            coords[b, :n] = np.stack([cells // (ny * nz),
                                      (cells // nz) % ny, cells % nz], -1)
            mask[b, :n] = True
            if case == "masked_on_valid":
                coords[b, n:] = coords[b, rng.choice(n, V - n)]
    if case not in ("sorted", "all_valid_and_all_masked"):
        for b in range(B):
            p = rng.permutation(V)
            coords[b], mask[b] = coords[b][p], mask[b][p]
    feats = torch.from_numpy(rng.normal(size=(B, V, C)).astype(np.float32))
    dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    return feats.to(dtype), torch.from_numpy(coords), torch.from_numpy(mask)


def _poison_next_block(shape, dtype, device):
    """Fill a block of the caching allocator with NaN and free it, so that
    the next allocation of that size starts from NaN, not from an earlier
    right answer: a cell the kernel leaves unwritten then shows."""
    torch.full(shape, float("nan"), dtype=dtype, device=device)


@pytest.mark.parametrize("case", ["sorted", "shuffled", "masked_on_valid",
                                  "edges", "all_valid_and_all_masked",
                                  "bfloat16"])
def test_scatter_grid_kernel_cases(cuda, case):
    """K4 bit-equal to the plain scatter, and its backward to autograd
    through it, in any row order, with masked rows on valid cells, at the
    grid's edges and block boundaries, on full and empty frames; one
    counted launch per call, two kernels (fill, rows) per launch."""
    grid = (24, 40, 10)
    feats, coords, mask = [t.to(cuda) for t in _k4_case(case, grid)]
    feats.requires_grad_()
    shape = (2, grid[2], grid[0], grid[1], feats.shape[-1])
    _poison_next_block(shape, feats.dtype, cuda)
    before = (scatter_grid.KERNEL.launches, scatter_grid.BWD_KERNEL.launches)
    got = scatter_grid.scatter_to_grid(feats, coords, mask, grid)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)
                    ).to(cuda, feats.dtype)
    (d,) = torch.autograd.grad(got, feats, g)
    assert (scatter_grid.KERNEL.launches,
            scatter_grid.BWD_KERNEL.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert [len(r["grid"]) for r in scatter_grid.KERNEL.last_launch] == [3, 3]
    want = scatter_voxels_to_grid(feats, coords, mask, grid)
    (want_d,) = torch.autograd.grad(want, feats, g)
    torch.cuda.synchronize()
    assert got.shape == shape
    assert torch.equal(got, want) and torch.equal(d, want_d)
    assert int((got != 0).any(-1).sum()) == int(mask.sum())


def test_scatter_grid_kernel_past_2_to_the_31_bytes(cuda):
    """Three frames of the default grid in float32 with 128 channels,
    2.16e9 bytes: rows at the last frame's last cells, beyond 2^31 bytes,
    land there; one launch, bit-equal to the plain scatter."""
    nx, ny, nz = grid = Config().voxel_shape
    n_cells = nx * ny * nz
    B, V, C = 3, 4096, 128
    assert B * n_cells * C * 4 > 2 ** 31
    rng = np.random.default_rng(7)
    # each frame's last four cells, then random others
    cells = np.stack([np.concatenate([
        n_cells - 1 - np.arange(4),
        rng.choice(n_cells - 4, V - 4, replace=False)]) for _ in range(B)])
    coords = np.stack([(cells // ny) % nx, cells % ny, cells // (nx * ny)],
                      -1).astype(np.int32)
    mask = rng.random((B, V)) < 0.9
    mask[:, :4] = True
    feats = torch.from_numpy(rng.normal(size=(B, V, C)).astype(np.float32)
                             ).to(cuda)
    coords, mask = torch.from_numpy(coords).to(cuda), \
        torch.from_numpy(mask).to(cuda)
    _poison_next_block((B, nz, nx, ny, C), torch.float32, cuda)
    before = scatter_grid.KERNEL.launches
    got = scatter_grid.scatter_to_grid(feats, coords, mask, grid)
    assert scatter_grid.KERNEL.launches == before + 1
    last = got[-1].reshape(n_cells, C)[-1]
    assert torch.equal(last, feats[-1, 0])
    want = scatter_voxels_to_grid(feats, coords, mask, grid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    del got, want
    torch.cuda.empty_cache()


def test_scatter_grid_refuses_what_it_does_not_take(cuda):
    feats, coords, mask = [t.to(cuda) for t in _voxels(5, 6, torch.float32)]
    with pytest.raises(ValueError, match="16-byte"):
        scatter_grid.scatter_to_grid(feats, coords, mask, (24, 40, 10))
    feats, coords, mask = [t.to(cuda) for t in _voxels(5, 8, torch.float32)]
    with pytest.raises(ValueError, match="coords"):
        scatter_grid.scatter_to_grid(feats, coords.long(), mask,
                                     (24, 40, 10))


def _gather_inputs(seed, B=2, P=300, C=256):
    rng = np.random.default_rng(seed)
    levels = [(16, 40), (8, 20), (4, 10)]
    feats = [rng.normal(size=(B, h, w, C)).astype(np.float32)
             for h, w in levels]
    r = rng.uniform(0, IMG[0], (B, P))
    c = rng.uniform(0, IMG[1], (B, P))
    r[:, :3], c[:, 3:6] = IMG[0], IMG[1]      # clamped far edges
    rc = np.stack([r, c], -1).astype(np.float32)
    ok = rng.random((B, P)) < 0.8
    if seed % 2:
        ok[1] = False                          # a frame with no point
    return feats, rc, ok


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("swapped", [False, True])
def test_gather_kernel_matches_plain(cuda, seed, swapped):
    feats, rc, ok = _gather_inputs(seed)
    args = ([torch.from_numpy(f).to(cuda) for f in feats],
            torch.from_numpy(rc).to(cuda), torch.from_numpy(ok).to(cuda))
    before = gather.KERNEL.launches
    got = gather.fpn_gather(*args, IMG, swapped_weights=swapped)
    assert gather.KERNEL.launches == before + 1
    want = gather.fpn_gather_plain(*args, IMG, swapped_weights=swapped)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[~args[2]].any()


@pytest.fixture
def second_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 1)


def test_kernels_launch_on_the_card_of_their_tensors(second_card):
    """K1 and K2 on cuda:1 while the current card is 0: each launch runs
    on the card its tensors lie on and equals its plain version (the C
    entry points launch on the current card, which ``CudaKernel.launch``
    sets to the tensors' card for the call)."""
    dev = second_card
    torch.cuda.set_device(0)
    y, col_cy, bounds, bias = [torch.from_numpy(a).to(dev)
                               for a in _columns(0, 320)]
    before = column_merge.KERNEL.launches
    out, stats = column_merge.merge_taps_fused(y, col_cy, bounds, bias,
                                               GRID)
    assert column_merge.KERNEL.launches == before + 1
    assert torch.cuda.current_device() == 0
    want_out, want_stats = _merge_reference(y, col_cy, bounds, bias, GRID)
    torch.cuda.synchronize(dev)
    assert out.device == dev and torch.equal(out, want_out)
    _assert_stats_close(stats, want_stats)
    feats, rc, ok = _gather_inputs(0)
    args = ([torch.from_numpy(f).to(dev) for f in feats],
            torch.from_numpy(rc).to(dev), torch.from_numpy(ok).to(dev))
    before = gather.KERNEL.launches
    got = gather.fpn_gather(*args, IMG)
    assert gather.KERNEL.launches == before + 1
    assert torch.cuda.current_device() == 0
    want = gather.fpn_gather_plain(*args, IMG)
    torch.cuda.synchronize(dev)
    assert got.device == dev
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("swapped", [False, True])
def test_gather_backward_on_card_matches_plain(cuda, dtype, swapped):
    """K2's backward through ``fpn_gather`` on the card (the forward is
    the kernel): float32 level gradients within 1e-5 of autograd through
    the plain version (the scatter-add sums in another order); bfloat16
    within one bfloat16 step of the same formula summed in float32 (plus
    2^-20 of the largest value for float32 summation order); no
    ``points_rc`` gradient."""
    feats, rc, ok = _gather_inputs(2)
    levels = [torch.from_numpy(f).to(cuda, dtype).requires_grad_(True)
              for f in feats]
    rc_t = torch.from_numpy(rc).to(cuda).requires_grad_(True)
    ok_t = torch.from_numpy(ok).to(cuda)
    cot = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 300, 768)).astype(np.float32)).to(cuda, dtype)
    before = gather.BACKWARD.launches
    gather.fpn_gather(levels, rc_t, ok_t, IMG,
                      swapped_weights=swapped).backward(cot)
    assert gather.BACKWARD.launches == before + 1
    assert rc_t.grad is None
    got = [f.grad for f in levels]
    if dtype == torch.float32:
        plain = [f.detach().clone().requires_grad_(True) for f in levels]
        gather.fpn_gather_plain(plain, rc_t.detach(), ok_t, IMG,
                                swapped_weights=swapped).backward(cot)
        for g, p in zip(got, plain):
            torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-5)
    else:
        summed = gather.fpn_gather_backward(
            cot, rc_t.detach(), ok_t, [f.shape for f in levels],
            [torch.float32] * 3, IMG, swapped_weights=swapped)
        scale = max(float(s.abs().max()) for s in summed)
        for g, s in zip(got, summed):
            assert g.dtype == torch.bfloat16
            assert _bf16_steps(g, s, scale * 2 ** -20) <= 1


def test_gather_kernel_refuses_what_it_does_not_take(cuda):
    feats, rc, ok = _gather_inputs(0, C=6)
    with pytest.raises(ValueError, match="C % 4"):
        gather.fpn_gather([torch.from_numpy(f).to(cuda) for f in feats],
                          torch.from_numpy(rc).to(cuda),
                          torch.from_numpy(ok).to(cuda), IMG)


@pytest.mark.parametrize("shapes,C", [
    (((16, 40), (8, 20), (4, 10)), 256),
    (((17, 41), (9, 21), (5, 11)), 136),
    (((7, 3), (13, 29), (2, 1)), 8)])
def test_gather_kernel_bf16_matches_plain(cuda, shapes, C):
    """K2 in bfloat16 at odd widths and levels that do not halve: one
    launch, bfloat16 out, invalid points 0, within 2^-5 of the largest
    level value of the plain bfloat16 version, and within one bfloat16
    step of the float32 sum of its own formula (plus 2^-20 of the largest
    level value for float32 summation order)."""
    rng = np.random.default_rng(C)
    B, P = 2, 300
    feats = [torch.from_numpy(rng.normal(size=(B, h, w, C)) * 4).to(
        cuda, torch.bfloat16) for h, w in shapes]
    rc = np.stack([rng.uniform(0, IMG[0], (B, P)),
                   rng.uniform(0, IMG[1], (B, P))], -1).astype(np.float32)
    rc[0, :3] = IMG
    ok = torch.from_numpy(rng.random((B, P)) < 0.8).to(cuda)
    rc = torch.from_numpy(rc).to(cuda)
    before = gather.KERNEL.launches
    got = gather.fpn_gather(feats, rc, ok, IMG)
    assert gather.KERNEL.launches == before + 1
    want = gather.fpn_gather_plain(feats, rc, ok, IMG)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == (B, P, 3 * C)
    scale = max(float(f.float().abs().max()) for f in feats)
    assert float((got.float() - want.float()).abs().max()) <= scale / 32
    summed = gather.fpn_gather_plain(feats, rc, ok, IMG,
                                     accumulate=torch.float32)
    assert _bf16_steps(got, summed, scale * 2 ** -20) <= 1
    assert not got[~ok].any()


def _bf16_steps(got, want, slack):
    """Largest |got - want| beyond ``slack``, in bfloat16 steps at
    max(|got|, |want|) of each value."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    step = torch.ldexp(torch.ones_like(g), e - 8)
    return float(((g - w).abs() - slack).clamp(min=0).div(step).max())


def test_gather_kernel_bf16_refuses_what_it_does_not_take(cuda):
    """bfloat16 levels need C % 8 == 0 and 16-byte alignment; mixed
    dtypes are refused."""
    feats = [torch.zeros((1, 4, 6, C), dtype=torch.bfloat16, device=cuda)
             for C in (8, 8, 12)]
    rc = torch.zeros((1, 5, 2), device=cuda)
    ok = torch.ones((1, 5), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="C % 8"):
        gather.fpn_gather(feats, rc, ok, IMG)
    shifted = torch.zeros(1 + 4 * 6 * 8, dtype=torch.bfloat16,
                          device=cuda)[1:].reshape(1, 4, 6, 8)
    with pytest.raises(ValueError, match="16-byte"):
        gather.fpn_gather([shifted, feats[0], feats[1]], rc, ok, IMG)
    with pytest.raises(ValueError):
        gather.fpn_gather([feats[0], feats[1].float(), feats[1]], rc, ok,
                          IMG)


def test_bf16_model_on_card_matches_cpu(cuda):
    """The fused model in bfloat16 (float32 masters, bfloat16 copies) on
    the card: bfloat16 maps, K1 and K2 in bfloat16, and the card's maps at
    most 2x as far from a float64 CPU run of the same weights as the
    CPU's own bfloat16 maps (floor 1e-2 of the largest value)."""
    cfg = TINY.replace(use_bf16=True)
    weights = build_model(cfg, seed=3, device="cpu").state_dict()
    rng = np.random.default_rng(1)
    frames = [synthetic_frame(rng, cfg, num_cars=2, num_points=1200)[:3]
              for _ in range(2)]
    maps = {}
    for name, dev, dtype, bf16 in (
            ("card", cuda, torch.float32, True),
            ("cpu_bf16", torch.device("cpu"), torch.float32, True),
            ("cpu64", torch.device("cpu"), torch.float64, False)):
        model = build_model(cfg, seed=None, device=dev)
        model.load_state_dict(weights)
        det = Detector(cfg.replace(use_bf16=bf16), model.to(dtype))
        pts, nums, imgs = det.assemble(frames)
        column_merge.KERNEL.launches = gather.KERNEL.launches = 0
        maps[name] = [m.cpu() for m in det.maps(pts, nums, imgs)]
        launches = (column_merge.KERNEL.launches, gather.KERNEL.launches)
        assert launches == ((1, 1) if dev.type == "cuda" else (0, 0))
        det.close()
    assert maps["card"][0].dtype == torch.bfloat16
    for g, c, w in zip(maps["card"], maps["cpu_bf16"], maps["cpu64"]):
        assert _dist(g.double(), w) <= max(2 * _dist(c.double(), w), 1e-2)


def test_remat_on_card_same_gradients_lower_peak(cuda):
    """The LiDAR-only model at the full default grid, batch 2: with remat
    CML conv1 runs twice per step (K1 launches twice), the peak device
    memory is lower, and every gradient sits within 10x the run-to-run
    distance of two steps without remat (atomics in PyTorch's index
    backward ops), floor 1e-5 relative."""
    cfg = Config(batch_size=2)
    rng = np.random.default_rng(0)
    arrays = []
    for i in range(2):
        pts, calib, image, boxes = synthetic_frame(rng, cfg)
        arrays.append(preprocess_train_frame(
            KittiFrame(f"f{i}", pts, None, calib, {"Car": boxes}), cfg,
            None, np.random.default_rng(i)))
    pts, nums, imgs, gts, gms, gcs = collate(arrays, cuda)
    gen = torch.Generator().manual_seed(0)
    perm = torch.stack([torch.randperm(cfg.max_points, generator=gen)
                        for _ in range(2)]).to(cuda)
    batch = frames_to_batch(pts, nums, imgs, cfg, gt_boxes=gts,
                            gt_mask=gms, gt_classes=gcs, perm=perm)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(cuda)
    weights = build_model(cfg, seed=2, device="cpu",
                          with_images=False).state_dict()
    runs = []
    for remat in (False, False, True):
        c = cfg.replace(remat=remat)
        model = build_model(c, seed=None, device=cuda, with_images=False)
        model.load_state_dict(weights)
        state = TrainState.create(c, model.train())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        column_merge.KERNEL.launches = 0
        make_train_step(c, anchors, with_images=False)(state, batch)
        torch.cuda.synchronize()
        runs.append((torch.cuda.max_memory_allocated(),
                     column_merge.KERNEL.launches,
                     {n: p.grad.double() for n, p in
                      model.named_parameters()}))
        del model, state
    (peak0, k0, g0), (_, _, g1), (peak_r, k_r, g_r) = runs
    assert (k0, k_r) == (1, 2)
    assert peak_r < peak0
    for n in g0:
        norm = float(g0[n].norm())
        noise = float((g1[n] - g0[n]).norm()) / norm
        assert float((g_r[n] - g0[n]).norm()) / norm <= max(10 * noise,
                                                             1e-5), n


def _maps(det, arrays):
    with torch.no_grad():
        pts, nums, imgs = (torch.as_tensor(a).to(det.device) for a in arrays)
        b = frames_to_batch(pts.to(det.dtype), nums, imgs.to(det.dtype),
                            TINY)
        return [m.cpu().double() for m in det.model(*model_inputs(b))]


def _dist(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def test_detector_on_card_matches_cpu(cuda):
    """The card's float32 maps sit at most 10x as far from a float64 CPU
    run of the same weights as the CPU's float32 maps do (an untrained
    model amplifies float32 rounding to ~1e-3 on any device)."""
    gpu = Detector.create(TINY, checkpoint_epoch=0, seed=3, device=cuda)
    weights = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    cpu = Detector.create(TINY, state_dict=weights, device="cpu")
    ref = build_model(TINY, seed=None, device="cpu")
    ref.load_state_dict(weights)
    ref = Detector(TINY, ref.double())
    rng = np.random.default_rng(0)
    frames = [synthetic_frame(rng, TINY, num_cars=2, num_points=1200)[:3]
              for _ in range(3)]
    arrays = cpu.assemble(frames)
    want = _maps(ref, arrays)
    for g, c, w in zip(_maps(gpu, arrays), _maps(cpu, arrays), want):
        assert _dist(g, w) <= max(10 * _dist(c, w), 1e-6)

    column_merge.KERNEL.launches = gather.KERNEL.launches = 0
    served = gpu.detect_frames(frames)
    streamed = list(gpu.detect_stream(frames, batch_size=2))
    assert column_merge.KERNEL.launches == gather.KERNEL.launches == 3
    assert len(streamed) == len(frames)
    for d in served:
        assert d.boxes.shape == (len(d.scores), 7)
        assert np.isfinite(d.boxes).all()
    # same frames in the same batch: bit-identical on the card
    again = gpu.detect_frames(frames)
    for a, b in zip(served, again):
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.scores, b.scores)
    for d in (gpu, cpu, ref):
        d.close()


def test_decode_batch_on_card_matches_cpu(cuda):
    """``decode_batch`` and its batched NMS on the card against the CPU on
    the same float32 maps at the default Config's anchors, batch 4: the
    NMS indices, ``valid``, classes and scores (picked, not computed)
    exact, the boxes within 1e-5."""
    cfg = Config()
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes))
    H, W, A, _ = anchors.shape
    rng = np.random.default_rng(5)
    score = torch.from_numpy(
        (rng.uniform(0, 1, (4, H, W, A)) ** 8).astype(np.float32))
    reg = torch.from_numpy(
        rng.normal(0, 0.2, (4, H, W, A * 7)).astype(np.float32))
    got = decode_batch(score.to(cuda), reg.to(cuda), anchors.to(cuda))
    want = decode_batch(score, reg, anchors)
    boxes = decode_boxes(reg.reshape(4, H, W, A, 7), anchors)
    kw = dict(iou_threshold=0.1, score_threshold=0.3)
    got_nms = rotated_nms_bev_batch(boxes.reshape(4, -1, 7).to(cuda),
                                    score.reshape(4, -1).to(cuda), **kw)
    want_nms = rotated_nms_bev_batch(boxes.reshape(4, -1, 7),
                                     score.reshape(4, -1), **kw)
    for g, w in zip(got_nms, want_nms):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.classes.cpu(), want.classes)
    assert torch.equal(got.scores.cpu(), want.scores)
    np.testing.assert_allclose(got.boxes.cpu().numpy(), want.boxes.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (want.valid.sum(1) > 10).all()


def test_voxel_fusion_on_card_matches_cpu(cuda):
    """``fusion_mode="voxel"``: the card's float32 maps within 10x the
    CPU's float32 distance from a float64 CPU run of the same weights;
    K1 and K2 launched once per batch served."""
    cfg = TINY.replace(fusion_mode="voxel")
    gpu = Detector.create(cfg, checkpoint_epoch=0, seed=3, device=cuda)
    weights = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    cpu = Detector.create(cfg, state_dict=weights, device="cpu")
    ref = build_model(cfg, seed=None, device="cpu")
    ref.load_state_dict(weights)
    ref = Detector(cfg, ref.double())
    rng = np.random.default_rng(1)
    frames = [synthetic_frame(rng, cfg, num_cars=2, num_points=1200)[:3]
              for _ in range(3)]
    arrays = cpu.assemble(frames)
    want = _maps(ref, arrays)
    for g, c, w in zip(_maps(gpu, arrays), _maps(cpu, arrays), want):
        assert _dist(g, w) <= max(10 * _dist(c, w), 1e-6)
    column_merge.KERNEL.launches = gather.KERNEL.launches = 0
    served = gpu.detect_frames(frames)
    streamed = list(gpu.detect_stream(frames, batch_size=2))
    assert column_merge.KERNEL.launches == gather.KERNEL.launches == 3
    assert len(streamed) == len(frames)
    for d in served:
        assert d.boxes.shape == (len(d.scores), 7)
        assert np.isfinite(d.boxes).all()
    for d in (gpu, cpu, ref):
        d.close()


def _train_batch(cfg, device, dtype=torch.float32):
    """Two synthetic frames with axis-aligned cars (so the regression
    head has positives) as a batch on ``device``, fixed shuffle."""
    rng = np.random.default_rng(5)
    arrays = []
    for i in range(2):
        pts, calib, image, boxes = synthetic_frame(
            rng, cfg, num_cars=3, num_points=1200, yaw_range=(0.0, 0.0))
        arrays.append(preprocess_train_frame(
            KittiFrame(f"f{i}", pts, image, calib, {"Car": boxes}), cfg,
            None, np.random.default_rng(i)))
    pts, nums, imgs, gts, gms, gcs = collate(arrays, device)
    gen = torch.Generator().manual_seed(0)
    perm = torch.stack([torch.randperm(cfg.max_points, generator=gen)
                        for _ in range(2)]).to(device)
    return frames_to_batch(pts.to(dtype), nums, imgs.to(dtype), cfg,
                           gt_boxes=gts.to(dtype), gt_mask=gms,
                           gt_classes=gcs, perm=perm)


def test_gradient_reaches_every_layer_on_card(cuda):
    """A loss through MVXNetPM on the card gives every trainable
    parameter a gradient: CML conv1, the VFE stack and the fusion MLP sit
    before K1, whose output must carry its backward."""
    model = build_model(TINY, seed=3, device=cuda).train()
    score, reg = model(*model_inputs(_train_batch(TINY, cuda)))
    (score.square().sum() + reg.square().sum()).backward()
    missing = [n for n, p in model.named_parameters()
               if "extractor" not in n and (p.grad is None
                                            or not p.grad.any())]
    assert not missing


@pytest.mark.parametrize("mode", ["column", "dense3d"])
def test_train_step_on_card_matches_cpu(cuda, mode, tmp_path):
    """One train step on the card against the same step in float64 on the
    CPU: the loss and each gradient at most 10x as far as the CPU's own
    float32 step (floor 1e-2 for a gradient: an untrained model's float32
    gradients sit ~5 % from float64 on any device, and a few closer on the
    CPU only because its float32 and float64 runs sum in one order).  The
    path's kernels launch, and a checkpoint of the card state restores
    bit-identically."""
    cfg = TINY.replace(batch_size=2, cml_mode=mode,
                       scatter_backend="pallas" if mode == "dense3d"
                       else "auto")
    weights = build_model(cfg, seed=4, device="cpu").state_dict()
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes))
    kernels = [*column_merge.KERNELS, *scatter_grid.KERNELS, gather.KERNEL]
    runs = {}
    for name, dev, dtype in (("card", cuda, torch.float32),
                             ("cpu32", torch.device("cpu"), torch.float32),
                             ("cpu64", torch.device("cpu"), torch.float64)):
        model = build_model(cfg, seed=None, device=dev)
        model.load_state_dict(weights)
        model = model.to(dtype).train()
        state = TrainState.create(cfg, model)
        for k in kernels:
            k.launches = 0
        m = make_train_step(cfg, anchors.to(dev, dtype))(
            state, _train_batch(cfg, dev, dtype))
        launches = {k.name: k.launches for k in kernels}
        runs[name] = (float(m["total_loss"]),
                      {n: p.grad.double().cpu()
                       for n, p in model.named_parameters()
                       if p.grad is not None}, launches, state)
    loss64, g64 = runs["cpu64"][:2]
    assert float(g64["backbone.rpn.reg.weight"].abs().max()) > 0
    card, cpu = runs["card"], runs["cpu32"]
    assert card[1].keys() == g64.keys()
    assert abs(card[0] - loss64) <= max(10 * abs(cpu[0] - loss64),
                                        1e-6 * abs(loss64))
    for k in g64:
        d_card = float((card[1][k] - g64[k]).norm() / g64[k].norm())
        d_cpu = float((cpu[1][k] - g64[k]).norm() / g64[k].norm())
        assert d_card <= max(10 * d_cpu, 1e-2), k
    on_path = (("column_merge", "column_merge_bwd", "merge_taps_bwd")
               if mode == "column" else ("scatter_grid", "scatter_grid_bwd"))
    assert all(card[2][n] == 1 for n in on_path + ("fpn_gather",))
    assert all(n in on_path + ("fpn_gather",) or c == 0
               for n, c in card[2].items())
    assert all(c == 0 for c in cpu[2].values())

    state = card[3]
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    other = TrainState.create(cfg, build_model(cfg, seed=5, device=cuda))
    ckpt.restore_checkpoint(str(tmp_path), 1, other)
    assert other.step == state.step == 1
    for a, b in zip(state.model.state_dict().values(),
                    other.model.state_dict().values()):
        assert torch.equal(a, b)


# kernels one forward and backward of the RPN's training plan launches at
# (4, 128, 352, 400); 904 measured on an H100 (torch 2.11, cuDNN 9.22),
# where the per-sample NCHW plan launched 136,743
RPN_TRAIN_LAUNCHES = 1200


def _rpn_maps_and_grads(rpn, x, fn, ws, wr):
    x = x.detach().clone().requires_grad_(True)
    rpn.zero_grad(set_to_none=True)
    score, reg = fn(x)
    ((score * ws).sum() + (reg * wr).sum()).backward()
    out = {"score": score, "reg": reg, "input": x.grad}
    out.update((n, p.grad) for n, p in rpn.named_parameters())
    return {k: v.detach().double().cpu() for k, v in out.items()}


def _rpn_per_sample(rpn):
    def fn(x):
        maps = [rpn.forward_one(x[i:i + 1]) for i in range(x.shape[0])]
        return (torch.cat([m[0] for m in maps]),
                torch.cat([m[1] for m in maps]))
    return fn


def test_rpn_training_plan_on_card(cuda, monkeypatch):
    """The RPN under autograd at the benchmark's grid, batch 4, float32
    without TF32 and with ``cudnn.deterministic`` off, as training runs
    (a ``Detector`` made earlier in the process turns it on): one forward
    and backward launches no FFT or gemv kernel and at most
    ``RPN_TRAIN_LAUNCHES`` kernels, and its maps and gradients sit as
    close to the per-sample NCHW plan as that plan's own second run does
    (norm-relative, 10x, floor 1e-5)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    torch.manual_seed(0)
    rpn = RPN(128).to(cuda)
    for m in rpn.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            torch.nn.init.constant_(m.bias, 1.0)
    g = torch.Generator(device=cuda).manual_seed(1)
    scale = torch.tensor([1.0, 10.0, 0.1, 3.0], device=cuda)
    x = torch.randn(4, 128, 352, 400, device=cuda, generator=g)
    x = x * scale[:, None, None, None]
    ws = torch.randn(4, 176, 200, 2, device=cuda, generator=g)
    wr = torch.randn(4, 176, 200, 14, device=cuda, generator=g)

    _rpn_maps_and_grads(rpn, x, rpn, ws, wr)             # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        plan = _rpn_maps_and_grads(rpn, x, rpn, ws, wr)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA"
             and not e.name.startswith(("Memcpy", "Memset"))]
    assert not [n for n in names if "fft" in n.lower() or "gemv" in n.lower()]
    assert 0 < len(names) <= RPN_TRAIN_LAUNCHES, len(names)

    ref = _rpn_maps_and_grads(rpn, x, _rpn_per_sample(rpn), ws, wr)
    again = _rpn_maps_and_grads(rpn, x, _rpn_per_sample(rpn), ws, wr)
    assert plan.keys() == ref.keys()
    for k in ref:
        norm = float(ref[k].norm())
        noise = float((again[k] - ref[k]).norm()) / norm
        assert float((plan[k] - ref[k]).norm()) / norm <= max(10 * noise,
                                                              1e-5), k
