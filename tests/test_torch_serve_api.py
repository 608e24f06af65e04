"""PyTorch port: the rest of ``serve.Detector``'s API on the CPU.

``stream_batches`` consumes pre-assembled batches and yields ``n_real``
detections per batch, in order (a padded short last batch included),
equal to ``detect_batch`` on the same arrays and to ``detect_frames``;
``detect_stream`` still equals ``detect_frames`` frame for frame, and
yields each batch's detections once that batch is read back, before the
next batch runs; ``set_params`` swaps the weights of a live detector, in
float32 and under ``use_bf16`` (whose bfloat16 copies must be cast again),
so that it serves exactly what a fresh ``Detector`` on the new weights
serves; ``run_batch`` decodes a batch in one pass into what a one-frame
decode of each frame's maps gives.

The CUDA graph of ``maps`` engages only on the card, without autograd or
a mesh, at a batch of one frame; its bookkeeping (eager at a new input
key, captured at the second call, replayed after, dropped by
``set_params`` and ``close``) runs here with a stand-in graph that
replays by running the forward on its static inputs.  The voxelizer's
constants, made once, hold the values it made on every call before.
"""

import contextlib
import importlib

import numpy as np
import pytest
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.eval.decode import (
    FrameDetections,
    decode_predictions,
)
from mvxnet_makise_tpu_torch import serve
from mvxnet_makise_tpu_torch.device import device_constant
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.serve import Detector, graph_engages

# the module: ``ops`` exports its function under the same name
voxelize_module = importlib.import_module(
    "mvxnet_makise_tpu_torch.ops.voxelize")

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0)
CFG = Config(**KW)


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


def test_serving_decodes_the_batch_as_frames_decode_alone(det, frames):
    """``run_batch`` decodes the whole batch in one pass: its detections,
    through ``detect_frames`` and ``detect_stream``, equal a one-frame
    ``decode_predictions`` of each frame's maps, bit for bit."""
    arrays = det.assemble(frames[:3])
    score, reg = det.maps(*arrays)
    want = []
    for s, r in zip(score, reg):
        d = decode_predictions(s.float(), r.float(), det.anchors,
                               score_threshold=det.score_threshold)
        v = d.valid.numpy()
        want.append(FrameDetections(boxes=d.boxes.numpy()[v],
                                    scores=d.scores.numpy()[v],
                                    classes=d.classes.numpy()[v]))
    batched = det.run_batch(*arrays)
    assert batched.boxes.shape == (3, det.post_max_size, 7)
    assert batched.valid.shape == (3, det.post_max_size)
    framed = det.detect_frames(frames[:3])
    streamed = list(det.detect_stream(iter(frames[:3]), batch_size=3))
    assert sum(len(w.scores) for w in want) > 0
    assert all(_same(g, w) for g, w in zip(framed, want))
    assert all(_same(g, w) for g, w in zip(streamed, want))


def test_detect_stream_yields_a_batch_once_it_is_read_back(det, frames,
                                                          monkeypatch):
    """Batch 0's frames come out while ``run_batch`` has run once: the
    stream holds no batch back for the next one."""
    calls = []
    run_batch = det.run_batch

    def counted(*args):
        calls.append(len(args[0]))
        return run_batch(*args)
    monkeypatch.setattr(det, "run_batch", counted)
    stream = det.detect_stream(iter(frames), batch_size=2)
    first = [next(stream), next(stream)]
    assert calls == [2]
    rest = list(stream)
    assert calls == [2, 2, 1] and len(rest) == 3
    want = det.detect_frames(frames[:2])
    assert all(_same(g, w) for g, w in zip(first, want))


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


@pytest.mark.parametrize("device,grad,mesh,batch,engages", [
    ("cuda", False, None, 1, True),
    ("cpu", False, None, 1, False),
    ("cuda", True, None, 1, False),
    ("cuda", False, "a mesh", 1, False),
    ("cuda", False, None, 2, False),
], ids=["card_batch1", "cpu", "autograd", "mesh", "batch2"])
def test_graph_plan_engages_only_on_the_card_at_batch_one(device, grad, mesh,
                                                          batch, engages):
    with torch.set_grad_enabled(grad):
        assert graph_engages(torch.device(device), mesh, batch) is engages


class _StandInGraph:
    """Replays by running the detector's forward on the static inputs
    into the static outputs, as the captured kernels would."""

    def __init__(self, det, inputs, outputs):
        self.det, self.inputs, self.outputs = det, inputs, outputs
        self.replays = 0

    def replay(self):
        self.replays += 1
        for out, new in zip(self.outputs, self.det._forward(*self.inputs)):
            out.copy_(new)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The graph path on the CPU: the plan engages at batch 1 without
    autograd on any device, ``torch.cuda.device`` is a no-op, and ``_capture`` makes a
    :class:`_StandInGraph` on zeroed static inputs; returns the keys
    captured."""
    captured = []

    def capture(self, key, host):
        inputs = tuple(torch.zeros(t.shape, dtype=d)
                       for t, d in zip(host, self._dtypes(host)))
        outputs = tuple(m.clone() for m in self._forward(*inputs))
        captured.append(key)
        return serve._Graph(key, _StandInGraph(self, inputs, outputs),
                            inputs, outputs)

    monkeypatch.setattr(serve, "graph_engages",
                        lambda device, mesh, batch:
                        batch == 1 and not torch.is_grad_enabled())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(Detector, "_capture", capture)
    return captured


@torch.no_grad()
def test_graph_is_captured_at_the_second_call_and_replayed_after(
        det, frames, stand_in_graphs):
    eager = Detector.create(CFG, state_dict=det.model.state_dict(),
                            device="cpu", score_threshold=0.0)
    arrays = [det.assemble([f]) for f in frames[:4]]
    got = []
    for i, a in enumerate(arrays):
        got.append(det.maps(*a))
        assert len(stand_in_graphs) == (0 if i == 0 else 1)
    graph = det._graph.graph
    assert graph.replays == 3
    # copies of the static maps, which the next replay overwrites
    assert all(m.data_ptr() != s.data_ptr()
               for m, s in zip(got[-1], det._graph.outputs))
    with torch.enable_grad():       # autograd declines the graph
        want = [eager.maps(*a) for a in arrays]
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g, w))
    d = decode_predictions(want[0][0][0].float(), want[0][1][0].float(),
                           det.anchors, score_threshold=det.score_threshold)
    v = d.valid.numpy()
    assert v.any()
    assert _same(det.detect_frames(frames[:1])[0], FrameDetections(
        boxes=d.boxes.numpy()[v], scores=d.scores.numpy()[v],
        classes=d.classes.numpy()[v]))
    assert graph.replays == 4
    # a new input key runs eagerly once, then captures anew
    pts, nums, imgs = arrays[0]
    wide = (pts, nums.astype(np.int64), imgs)
    det.maps(*wide)
    assert len(stand_in_graphs) == 1 and det._graph.graph is graph
    det.maps(*wide)
    assert len(stand_in_graphs) == 2 and det._graph.graph is not graph
    # batches of two frames stay eager
    det.maps(*det.assemble(frames[:2]))
    assert len(stand_in_graphs) == 2
    det._graph = None
    eager.close()


def test_set_params_and_close_drop_the_graph(frames, stand_in_graphs):
    det = Detector.create(CFG, checkpoint_epoch=0, seed=0, device="cpu")
    arrays = det.assemble(frames[:1])
    with torch.no_grad():
        det.maps(*arrays)
        det.maps(*arrays)
    assert det._graph is not None
    det.set_params(build_model(CFG, seed=1, device="cpu").state_dict())
    assert det._graph is None
    with torch.no_grad():
        det.maps(*arrays)       # the key was seen: captures at once
    assert det._graph is not None and len(stand_in_graphs) == 2
    det.close()
    assert det._graph is None


@torch.no_grad()
def test_cpu_detector_keeps_no_graph(frames):
    det = Detector.create(CFG, checkpoint_epoch=0, seed=0, device="cpu")
    for f in frames[:3]:
        det.detect_frames([f])
    assert det._graph is None and det._graph_key is None
    det.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_voxelize_constants_are_made_once_with_the_values_made_per_call(
        det, frames, monkeypatch, dtype):
    kw = dict(velo_range=CFG.velo_range, voxel_size=CFG.voxel_size,
              grid_shape=CFG.voxel_shape, max_voxels=CFG.max_voxels,
              samples_per_voxel=CFG.samples_per_voxel)
    for values, dt in ((CFG.velo_range[:3], dtype), (CFG.voxel_size, dtype),
                       (CFG.voxel_shape, torch.int32)):
        made = device_constant(values, dt, torch.device("cpu"))
        assert made is device_constant(list(values), dt, "cpu")
        fresh = torch.tensor(values, dtype=dt)
        assert made.dtype == fresh.dtype and torch.equal(made, fresh)
    pts, nums, _ = (torch.from_numpy(a) for a in det.assemble(frames[:3]))
    pts = pts.to(dtype)
    got = voxelize_module.voxelize(pts, nums, **kw)
    # the constants as they were made before: anew on every call
    monkeypatch.setattr(voxelize_module, "device_constant",
                        lambda values, dt, device: torch.tensor(
                            values, dtype=dt, device=device))
    want = voxelize_module.voxelize(pts, nums, **kw)
    assert int(want.num_voxels.sum()) > 0
    for name, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
