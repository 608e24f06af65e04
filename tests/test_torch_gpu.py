"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and ``Detector`` on ``cuda`` against the same weights on the CPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerances: K1 sums the same taps in the same order as its plain version
(1e-5 on float32; bfloat16 outputs round to 8 bits, 2e-2); K2 rounds its
four weighted taps in another order (1e-5).
"""

import numpy as np
import pytest
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.ops import column_merge, gather
from mvxnet_makise_tpu_torch.serve import Detector
from mvxnet_makise_tpu_torch.train.step import frames_to_batch, model_inputs

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


def _columns(seed, R, B=2, V=160):
    """Sorted active BEV columns: frame 0 empty, frame 1 with one whole
    BEV row filled (many columns per row) plus random cells."""
    rng = np.random.default_rng(seed)
    nx, ny, _ = GRID
    col_cy = np.zeros((B, V), np.int32)
    bounds = np.zeros((B, nx + 1), np.int32)
    for b in range(1, B):
        cells = rng.choice(nx * ny, V // 2, replace=False)
        cells = np.unique(np.concatenate(
            [rng.integers(0, nx) * ny + np.arange(ny), cells]))[:V]
        col_cy[b, :len(cells)] = cells % ny
        bounds[b] = np.searchsorted(cells // ny, np.arange(nx + 1))
    y = rng.normal(size=(B, V, 9, R)).astype(np.float32)
    bias = rng.normal(size=(R,)).astype(np.float32)
    return y, col_cy, bounds, bias


@pytest.mark.parametrize("R", [6, 320])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_merge_kernel_matches_plain(cuda, R, dtype, tol):
    y, col_cy, bounds, bias = [torch.from_numpy(a).to(cuda)
                               for a in _columns(0, R)]
    y = y.to(dtype)
    before = column_merge.KERNEL.launches
    out, stats = column_merge.merge_taps_fused(y, col_cy, bounds, bias,
                                               GRID)
    assert column_merge.KERNEL.launches == before + 1
    want_out, want_stats = column_merge.merge_taps_fused_plain(
        y, col_cy, bounds, bias, GRID)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(stats, want_stats, rtol=tol, atol=tol * 10)
    # the empty frame is relu(bias) everywhere
    torch.testing.assert_close(
        out[0].float(), torch.relu(bias).to(dtype).float().expand(
            *GRID[:2], R), rtol=0, atol=0)


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


def test_gather_kernel_refuses_what_it_does_not_take(cuda):
    feats, rc, ok = _gather_inputs(0, C=6)
    with pytest.raises(ValueError, match="C % 4"):
        gather.fpn_gather([torch.from_numpy(f).to(cuda) for f in feats],
                          torch.from_numpy(rc).to(cuda),
                          torch.from_numpy(ok).to(cuda), IMG)


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
    gpu = Detector.create(TINY, seed=3, device=cuda)
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
