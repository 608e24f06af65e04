"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, a tiny size on the CPU, and each fault
the cell can have (one card: no exchange between cards)."""

import contextlib

import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import TINY

SEED = 2 ** 33 + 21


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def altered_answer():
    """A served box moved by 2 m where the detections are produced."""
    from mvxnet_makise_tpu_torch import serve

    inner = serve.decode_batch

    def decode(*a, **kw):
        det = inner(*a, **kw)
        boxes = det.boxes.clone()
        boxes[:, 0, 0] += 2.0
        return det._replace(boxes=boxes)

    return patched(serve, "decode_batch", decode)


def nms_suppresses_nothing():
    """The rotated NMS keeps every candidate above the score threshold."""
    from mvxnet_makise_tpu_torch.eval import decode

    inner = decode.rotated_nms_bev_batch

    def nms(*a, **kw):
        return inner(*a, **{**kw, "iou_threshold": 2.0})

    return patched(decode, "rotated_nms_bev_batch", nms)


def nms_keeps_top_only():
    """The rotated NMS keeps each frame's best box and drops the rest."""
    from mvxnet_makise_tpu_torch.eval import decode

    inner = decode.rotated_nms_bev_batch

    def nms(*a, **kw):
        idx, scores, valid = inner(*a, **kw)
        valid = valid.clone()
        valid[:, 1:] = False
        return idx, scores, valid

    return patched(decode, "rotated_nms_bev_batch", nms)


def half_batch_serving():
    """Half the batch run, its maps given to the other half."""
    from mvxnet_makise_tpu_torch.serve import Detector

    inner = Detector.maps

    def maps(self, points, num_points, images):
        h = max(1, len(points) // 2)
        s, r = inner(self, points[:h], num_points[:h], images[:h])
        reps = -(-len(points) // h)
        return s.repeat(reps, 1, 1, 1)[:len(points)], \
            r.repeat(reps, 1, 1, 1)[:len(points)]

    return patched(Detector, "maps", maps)


def unchanged_state():
    """A step that leaves the parameters as they were."""
    from mvxnet_makise_tpu_torch.train.state import TrainState

    def apply_gradients(self):
        self.step += 1

    return patched(TrainState, "apply_gradients", apply_gradients)


def half_batch_training():
    """The loss taken over the first half of the batch only."""
    from mvxnet_makise_tpu_torch.ops.assign import AnchorTargets
    from mvxnet_makise_tpu_torch.train import step

    inner = step.compute_loss

    def compute_loss(model, batch, targets, anchors, cfg, with_images=True):
        h = max(1, batch.coords.shape[0] // 2)
        half = batch._replace(**{k: v[:h] for k, v in batch._asdict().items()
                                 if isinstance(v, torch.Tensor)})
        return inner(model, half, AnchorTargets(*(t[:h] for t in targets)),
                     anchors, cfg, with_images)

    return patched(step, "compute_loss", compute_loss)


def exchange_left_out():
    """Each rank's gradients left as they are: no all-reduce over the data
    ranks."""
    from mvxnet_makise_tpu_torch.train import step

    return patched(step, "_data_mean", lambda tensors, group, n: None)


CASES = [("fusion_serve_b4", altered_answer),
         ("fusion_serve_b4", half_batch_serving),
         ("fusion_serve_b4", nms_suppresses_nothing),
         ("fusion_serve_b4", nms_keeps_top_only),
         ("lidar_sensor_10hz", altered_answer),
         ("lidar_sensor_10hz", nms_suppresses_nothing),
         ("lidar_sensor_10hz", nms_keeps_top_only),
         ("fusion_train_b4", unchanged_state),
         ("fusion_train_b4", half_batch_training)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault):
    # the LiDAR-only model's bfloat16 weights move a tiny grid's maps as
    # far as a moved box; its arithmetic is held at the full size on the
    # card, and here the faults in float32
    over = {**TINY, "config": {**TINY["config"], "use_bf16": False}}
    sound = run.run_cell(cell, SEED, 1.0, False, device="cpu",
                         overrides=over)["checks"]
    with fault():
        broken = run.run_cell(cell, SEED, 1.0, False, device="cpu",
                              overrides=over)
    assert broken["correct"] is False
    # the held number the fault fails reads far above the sound run's
    assert max(broken["checks"][k]["value"] / max(sound[k]["value"], 1e-12)
               for k in sound
               if broken["checks"][k]["value"] > sound[k]["limit"]) > 10


DP_FAULTS = [unchanged_state, half_batch_training, exchange_left_out]


@pytest.mark.parametrize("fault", DP_FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct_across_ranks(fault):
    # four gloo ranks on the CPU; each rank enters the fault itself
    over = {**TINY, "config": {**TINY["config"], "use_bf16": False}}
    sound = run.run_cell("fusion_train_dp4", SEED, 1.0, False,
                         device="cpu", overrides=over)["checks"]
    broken = run.run_cell("fusion_train_dp4", SEED, 1.0, False,
                          device="cpu", overrides={
                              **over, "patch": f"{__name__}:{fault.__name__}"})
    assert broken["correct"] is False
    assert max(broken["checks"][k]["value"] / max(sound[k]["value"], 1e-12)
               for k in sound
               if broken["checks"][k]["value"] > sound[k]["limit"]) > 10
