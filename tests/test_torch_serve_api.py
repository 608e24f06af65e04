"""PyTorch port: the rest of ``serve.Detector``'s API on the CPU.

``stream_batches`` consumes pre-assembled batches and yields ``n_real``
detections per batch, in order (a padded short last batch included),
equal to ``detect_batch`` on the same arrays and to ``detect_frames``;
``detect_stream``, now built on it, still equals ``detect_frames`` frame
for frame; ``set_params`` swaps the weights of a live detector, in
float32 and under ``use_bf16`` (whose bfloat16 copies must be cast again),
so that it serves exactly what a fresh ``Detector`` on the new weights
serves.
"""

import numpy as np
import pytest
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.serve import Detector

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0)
CFG = Config(**KW)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return [synthetic_frame(rng, CFG, num_cars=2, num_points=n)[:3]
            for n in (900, 1500, 1200, 700, 1100)]


@pytest.fixture(scope="module")
def det():
    d = Detector.create(CFG, checkpoint_epoch=0, seed=0, device="cpu",
                        score_threshold=0.0)
    yield d
    d.close()


def _same(a, b):
    return (np.array_equal(a.boxes, b.boxes)
            and np.array_equal(a.scores, b.scores)
            and np.array_equal(a.classes, b.classes))


def test_stream_batches_yields_n_real_per_batch(det, frames):
    full = [det.assemble(frames[0:2]), det.assemble(frames[2:4])]
    # a short last batch: frame 4 padded with a copy of itself
    short = det.assemble([frames[4], frames[4]])
    batches = [(*full[0], 2), (*full[1], 2), (*short, 1)]
    got = list(det.stream_batches(iter(batches), batch_size=2))
    assert len(got) == 5
    want = (det.detect_batch(*full[0]) + det.detect_batch(*full[1])
            + det.detect_batch(*short)[:1])
    assert all(_same(g, w) for g, w in zip(got, want))
    assert sum(len(g.scores) for g in got) > 0
    direct = det.detect_frames(frames)
    for g, d in zip(got, direct):
        assert len(g.scores) == len(d.scores)
        np.testing.assert_allclose(g.scores, d.scores, atol=1e-6)
        np.testing.assert_allclose(g.boxes, d.boxes, atol=1e-5)
    # tensors are accepted too
    pts, nums, imgs = (torch.from_numpy(a) for a in full[0])
    again = list(det.stream_batches([(pts, nums, imgs, 2)], 2))
    assert all(_same(g, w) for g, w in zip(again, want[:2]))


@pytest.mark.parametrize("n_real,batch_size", [(3, 2), (0, 2), (2, 1)])
def test_stream_batches_refuses_batches_that_do_not_fit(det, frames,
                                                        n_real, batch_size):
    arrays = det.assemble(frames[:2])
    with pytest.raises(ValueError, match="does not fit"):
        list(det.stream_batches([(*arrays, n_real)], batch_size))


def test_detect_stream_equals_detect_frames(det, frames):
    streamed = list(det.detect_stream(iter(frames), batch_size=2))
    assert len(streamed) == len(frames)
    for i in range(0, len(frames), 2):
        want = det.detect_frames(frames[i:i + 2])
        assert all(_same(g, w) for g, w in zip(streamed[i:i + 2], want))


@pytest.mark.parametrize("use_bf16", [False, True], ids=["float32", "bf16"])
@torch.no_grad()
def test_set_params_serves_the_new_weights(frames, use_bf16):
    cfg = CFG.replace(use_bf16=use_bf16)
    new = build_model(cfg, seed=1, device="cpu").state_dict()
    det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device="cpu",
                          score_threshold=0.0)
    fresh = Detector.create(cfg, state_dict=new, device="cpu",
                            score_threshold=0.0)
    arrays = det.assemble(frames[:2])
    before = det.maps(*arrays)
    det.set_params(new)
    got, want = det.maps(*arrays), fresh.maps(*arrays)
    assert got[0].dtype == (torch.bfloat16 if use_bf16 else torch.float32)
    assert not torch.equal(got[0], before[0])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(_same(g, w) for g, w in zip(det.detect_frames(frames[:2]),
                                           fresh.detect_frames(frames[:2])))
    with pytest.raises(RuntimeError):
        det.set_params({k: v for k, v in new.items()
                        if not k.startswith("head.fusion.")})
    det.close()
    fresh.close()
