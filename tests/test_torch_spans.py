"""PyTorch port: the spans of ``utils/profiling`` on the CPU.

With no profiler running a span is one shared no-op object; under
``torch.profiler`` each span is a range on the calling thread, nested
as the spans are and holding the work done inside, and a thread the
profiler does not trace gets the no-op.  ``Detector.detect_stream``
opens, for every batch, the serving vocabulary; a training step opens
the training vocabulary in order (the all-reduce under a mesh), the
RPN's batched training plan once a step and never in serving; NMS
opens one ``mvx.sync`` span per fixpoint check.  Tracing changes no
detection, loss or parameter.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.geometry.boxes import rotated_iou_bev
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.ops.nms import (
    _SWEEPS_PER_CHECK,
    rotated_nms_bev_batch,
)
from mvxnet_makise_tpu_torch.serve import Detector
from mvxnet_makise_tpu_torch.train.loop import (
    collate,
    make_full_train_step,
    preprocess_train_frame,
)
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    frames_to_batch,
    make_train_step,
)
from mvxnet_makise_tpu_torch.utils import profiling as P
from mvxnet_makise_tpu_torch.utils.metrics import PhaseTimer

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0, batch_size=2)
CFG = Config(**KW)

SERVING = ("mvx.serve.feed_wait", "mvx.serve.upload",
           "mvx.model.voxelize", "mvx.model.image", "mvx.model.vfe",
           "mvx.model.cml", "mvx.model.rpn", "mvx.serve.decode",
           "mvx.serve.nms", "mvx.serve.readback")
TRAINING = ("mvx.train.assign", "mvx.train.forward", "mvx.train.loss",
            "mvx.train.backward", "mvx.train.finite_check",
            "mvx.train.optimizer")


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


def _traced(fn):
    """fn() under ``torch.profiler`` (CPU): its result and the ``mvx.*``
    ranges of the window, in the order they opened."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e for e in prof.events() if e.name.startswith("mvx.")),
                   key=lambda e: e.time_range.start)
    return out, spans


def _span_parent(event):
    """The innermost ``mvx.*`` range around ``event`` (None at the top)."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("mvx."):
        p = p.cpu_parent
    return p


def _children(spans, parent):
    return [s for s in spans if _span_parent(s) is parent]


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _within(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_off_is_the_shared_no_op():
    a, b = P.span("mvx.a"), P.span("mvx.b")
    assert a is b and P.sync_point() is a
    with a:
        with P.sync_point():
            pass
    assert P.span("mvx.a") is a


def test_nested_spans_are_nested_profiler_ranges():
    def work():
        with P.span("mvx.outer"):
            with P.span("mvx.inner"):
                pass
            with P.span("mvx.other"):
                pass

    _, spans = _traced(work)
    outer, inner, other = spans
    assert [s.name for s in spans] == ["mvx.outer", "mvx.inner",
                                       "mvx.other"]
    assert _span_parent(outer) is None
    assert _span_parent(inner) is outer and _span_parent(other) is outer
    assert len({s.thread for s in spans}) == 1
    assert _within(inner, outer) and _within(other, outer)
    assert inner.time_range.end <= other.time_range.start
    # the profiler has stopped: spans are no-ops again
    assert P.span("mvx.x") is P.span("mvx.y")


def test_span_on_an_untraced_thread_is_a_no_op():
    """The profiler traces the thread that started it; a span on any
    other thread, such as ``detect_stream``'s feed, is the no-op and
    leaves no range."""
    pool = ThreadPoolExecutor(max_workers=1)
    pool.submit(lambda: None).result()

    def work():
        with P.span("mvx.pool") as s:
            torch.ones(8) @ torch.ones(8)
        return s

    try:
        (here, there), spans = _traced(
            lambda: (P.span("mvx.main"), pool.submit(work).result()))
    finally:
        pool.shutdown()
    assert there is P.span("mvx.any") and here is not there
    assert spans == []


def test_span_range_holds_its_work():
    def work():
        for _ in range(3):
            with P.span("mvx.test.range"):
                torch.ones(64, 64) @ torch.ones(64, 64)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    events = prof.events()
    ranges = [e for e in events if e.name == "mvx.test.range"]
    mms = [e for e in events if e.name == "aten::mm"]
    assert len(ranges) == len(mms) == 3
    for mm in mms:
        owner = _span_parent(mm)
        assert owner in ranges and _within(mm, owner)


def test_profiler_alone_opens_the_ranges():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("mvx.test.alone"):
            with P.sync_point():
                pass
    names = [e.name for e in prof.events()]
    assert names.count("mvx.test.alone") == 1
    assert names.count(P.SYNC) == 1


def test_detect_stream_records_the_serving_vocabulary(det, frames):
    got, spans = _traced(
        lambda: list(det.detect_stream(frames, batch_size=2)))
    assert len(got) == len(frames)
    assert set(SERVING) <= {s.name for s in spans}
    batches = _named(spans, "mvx.serve.batch")
    waits = _named(spans, "mvx.serve.feed_wait")
    # one wait before each batch, and one more for the stream's end
    assert len(batches) == 3 and len(waits) == 4
    for wait, b in zip(waits, batches):
        assert _span_parent(wait) is None
        assert wait.time_range.end <= b.time_range.start
        assert [s.name for s in _children(spans, b)] == [
            "mvx.serve.upload", "mvx.model.voxelize", "mvx.model.image",
            "mvx.model.vfe", "mvx.model.vfe", "mvx.model.cml",
            "mvx.model.rpn", "mvx.serve.decode", "mvx.serve.readback"]
    assert len({s.thread for s in spans}) == 1
    # serving runs the RPN without gradients: never the training plan
    assert not _named(spans, "mvx.model.rpn.batched")
    for nms in _named(spans, "mvx.serve.nms"):
        assert _span_parent(nms).name == "mvx.serve.decode"
    for up in _named(spans, "mvx.serve.upload"):
        assert [s.name for s in _children(spans, up)] == [P.SYNC] * 3
    for rb in _named(spans, "mvx.serve.readback"):
        assert [s.name for s in _children(spans, rb)] == [P.SYNC] * 4


def _train_tensors(seed=0):
    rng = np.random.default_rng(seed)
    arrays = []
    for i, n in enumerate((900, 1500)):
        pts, calib, image, cars = synthetic_frame(
            rng, CFG, num_cars=3, num_points=n, yaw_range=(0.0, 0.0))
        arrays.append(preprocess_train_frame(
            KittiFrame(f"f{i}", pts, image, calib, {"Car": cars}), CFG,
            None, np.random.default_rng(i)))
    g = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(CFG.max_points, generator=g)
                        for _ in range(2)])
    return (*collate(arrays, torch.device("cpu")), perm)


def _state(seed=0):
    model = build_model(CFG, seed=seed, device="cpu").train()
    return TrainState.create(CFG, model)


def _anchors():
    return torch.from_numpy(create_anchors(
        CFG.feature_map_shape, CFG.velo_range, CFG.anchor_sizes))


def test_train_step_records_the_training_vocabulary_in_order():
    state = _state()
    step = make_full_train_step(CFG, _anchors())
    tensors = _train_tensors()
    _, spans = _traced(lambda: step(state, *tensors))
    top = _children(spans, None)
    assert [s.name for s in top] == ["mvx.model.voxelize", "mvx.train.step"]
    root = top[1]
    kids = _children(spans, root)
    assert [s.name for s in kids] == list(TRAINING)
    forward = kids[1]
    assert [s.name for s in _children(spans, forward)] == [
        "mvx.model.image", "mvx.model.vfe", "mvx.model.vfe",
        "mvx.model.cml", "mvx.model.rpn"]
    # the RPN's training plan: one batched call inside the RPN's span
    rpn = _children(spans, forward)[-1]
    batched = _named(spans, "mvx.model.rpn.batched")
    assert len(batched) == 1 and _span_parent(batched[0]) is rpn
    assert _children(spans, rpn) == batched
    check = kids[4]
    assert [s.name for s in _children(spans, check)] == [P.SYNC]
    assert not _named(spans, "mvx.train.allreduce")


def test_mesh_step_records_the_allreduce(tmp_path):
    import torch.distributed as dist

    from mvxnet_makise_tpu_torch.parallel import make_mesh, shard_params

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1))
        model = shard_params(build_model(CFG, seed=0, device="cpu").train(),
                             mesh)
        state = TrainState.create(CFG, model)
        pts, nums, imgs, gts, gms, gcs, perm = _train_tensors()
        batch = frames_to_batch(pts, nums, imgs, CFG, gt_boxes=gts,
                                gt_mask=gms, gt_classes=gcs, perm=perm)
        step = make_train_step(CFG, _anchors(), mesh=mesh)
        _, spans = _traced(lambda: step(state, batch))
    finally:
        dist.destroy_process_group()
    root, = _named(spans, "mvx.train.step")
    rpn, = _named(spans, "mvx.model.rpn")
    batched, = _named(spans, "mvx.model.rpn.batched")
    assert _span_parent(batched) is rpn
    names = [s.name for s in _children(spans, root)]
    assert names == ["mvx.train.assign", "mvx.train.forward",
                     "mvx.train.loss", "mvx.train.backward",
                     "mvx.train.allreduce", "mvx.train.finite_check",
                     "mvx.train.allreduce", "mvx.train.optimizer"]


def _chain(K):
    """K boxes in a row along x, each overlapping the next (IoU 1/3),
    scores falling along the row: greedy NMS keeps every other box, and
    the fixpoint sweep settles one box per sweep."""
    x = torch.arange(K, dtype=torch.float64) * 0.5
    boxes = torch.zeros((1, K, 7), dtype=torch.float64)
    boxes[0, :, 0] = x
    boxes[0, :, 3] = 1.0
    boxes[0, :, 4] = 1.0
    boxes[0, :, 5] = 1.0
    scores = torch.linspace(1.0, 0.5, K, dtype=torch.float64)[None]
    return boxes, scores


def _checks(boxes, scores, K, thr):
    """Convergence checks of ``rotated_nms_bev_batch``'s sweep, counted
    from the same IoU."""
    iou = rotated_iou_bev(boxes[0], boxes[0]).numpy()
    sup = (iou > thr) & (np.arange(K)[:, None] < np.arange(K)[None, :])
    alive = np.ones(K, bool)
    keep, checks = alive, 0
    for _ in range(0, K + 1, _SWEEPS_PER_CHECK):
        for _ in range(_SWEEPS_PER_CHECK):
            prev = keep
            keep = alive & ~(sup & keep[:, None]).any(axis=0)
        checks += 1
        if np.array_equal(keep, prev):
            break
    return checks, keep


@pytest.mark.parametrize("K", [3, 12, 30])
def test_nms_counts_one_sync_per_fixpoint_check(K):
    boxes, scores = _chain(K)
    want, keep = _checks(boxes, scores, K, 0.1)
    assert want >= K // 2 // _SWEEPS_PER_CHECK
    _, iou_spans = _traced(lambda: rotated_iou_bev(boxes, boxes))
    (idx, _, valid), spans = _traced(lambda: rotated_nms_bev_batch(
        boxes, scores, iou_threshold=0.1, pre_max_size=K, post_max_size=K))
    assert int(valid.sum()) == int(keep.sum()) == (K + 1) // 2
    assert len(_named(spans, P.SYNC)) == want + len(_named(iou_spans,
                                                          P.SYNC))


def test_recording_changes_no_detection(det, frames):
    """Detections with the spans' ranges recorded by the profiler and
    without."""
    plain = list(det.detect_stream(frames, batch_size=2))
    recorded, spans = _traced(
        lambda: list(det.detect_stream(frames, batch_size=2)))
    assert spans
    for a, b in zip(plain, recorded):
        assert np.array_equal(a.boxes, b.boxes)
        assert np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.classes, b.classes)


def test_recording_changes_no_loss_or_parameter():
    step = make_full_train_step(CFG, _anchors())
    tensors = _train_tensors()
    out = []
    for recorded in (False, True):
        torch.manual_seed(0)
        state = _state()
        if recorded:
            metrics, spans = _traced(lambda: step(state, *tensors))
            assert spans
        else:
            metrics = step(state, *tensors)
        out.append((metrics, dict(state.model.named_parameters())))
    (m0, p0), (m1, p1) = out
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_phase_timer_phases_are_spans():
    timer = PhaseTimer()

    def work():
        with timer.phase("host_wait"):
            with P.span("mvx.inside"):
                pass
        with timer.phase("host_wait"):
            pass

    _, spans = _traced(work)
    with timer.phase("host_wait"):
        pass
    assert [s.name for s in spans] == ["mvx.loop.host_wait", "mvx.inside",
                                       "mvx.loop.host_wait"]
    assert _span_parent(spans[1]) is spans[0]
    assert timer.counts["host_wait"] == 3
    assert "host_wait" in timer.report()
