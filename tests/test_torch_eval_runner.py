"""PyTorch port: ``eval/runner.run_eval`` against the JAX package's, at the
small configuration (grid (32, 40, 10), 64x96 images), with the same
weights (``models/weights.load_jax_params``) and frames.

Both models run in float64: the port's model is cast to float64, and
JAX's ``run_eval`` runs with its jitted ``infer`` compiled under
``jax.enable_x64`` without XLA's algebraic simplifier (see
``tests/test_torch_detector.py``), its float32 inputs and weights cast to
float64.  Both decode float32 maps.  Per frame the detections come in the
same order and classes, the scores agree to 1e-6 and the boxes to 1e-6
relative to their largest coordinate (float32 decoding: a coordinate near
12 m is 1e-6 wide in 1 ulp, and the two decoders' ``exp`` differ by an
ulp), and the AP dicts of every difficulty bucket are equal.  Five frames
at batch 2 exercise the padded tail.
"""

import jax
import numpy as np
import pytest

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.data.kitti import KittiFrame as JaxKittiFrame
from mvxnet_makise_tpu.eval import runner as jax_runner
from mvxnet_makise_tpu.geometry.calib import Calib as JaxCalib
from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.eval.runner import detect_for_eval, run_eval
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.weights import load_jax_params
from _jax_ref import jit_without_algsimp
from test_torch_detector import _random_params

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0)
CFG = Config(**KW)


def _frames(rng, n=5):
    port, jax_frames = [], []
    for i in range(n):
        pts, calib, image, boxes = synthetic_frame(
            rng, CFG, num_cars=2, num_points=int(rng.integers(800, 1500)))
        diff = rng.integers(-1, 3, len(boxes)).astype(np.int32)
        common = dict(frame_id=f"{i:06d}", points=pts, image=image,
                      boxes={"Car": boxes},
                      bbox2d={"Car": np.zeros((len(boxes), 4), np.float32)},
                      difficulty={"Car": diff})
        port.append(KittiFrame(calib=calib, **common))
        jax_frames.append(JaxKittiFrame(calib=JaxCalib(*calib), **common))
    return port, jax_frames


@pytest.fixture(scope="module")
def eval_run():
    rng = np.random.default_rng(0)
    jcfg = JaxConfig(**KW)
    model = JaxMVXNetPM(
        grid_shape=jcfg.voxel_shape, image_size=jcfg.image_size,
        anchors_per_loc=jcfg.anchors_per_loc,
        image_min_side=jcfg.image_min_side,
        samples_per_voxel=jcfg.samples_per_voxel, cml_mode=jcfg.cml_mode)
    params = _random_params(model, jcfg, rng)
    frames, jax_frames = _frames(rng)

    port = build_model(CFG, seed=None, device="cpu")
    load_jax_params(port, params)
    port = port.double().train()
    dets = detect_for_eval(CFG, frames, port, batch_size=2)
    result = run_eval(CFG, frames, port, batch_size=2)

    decoded = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax, "jit", jit_without_algsimp(decoded))
        want = jax_runner.run_eval(jcfg, jax_frames, params, model, True,
                                   batch_size=2)
    return dict(dets=dets, result=result, want=want, decoded=decoded,
                model=port)


def test_decoded_boxes_match_jax(eval_run):
    dets, decoded = eval_run["dets"], eval_run["decoded"]
    assert len(decoded) == 3                  # batches of 2, 2 and 1 + pad
    want = []
    for d in decoded:
        for b in range(len(d.valid)):
            v = np.asarray(d.valid[b])
            want.append((d.boxes[b][v], d.scores[b][v], d.classes[b][v]))
    assert len(dets) == 5
    for got, (boxes, scores, classes) in zip(dets, want[:5]):
        assert len(got.scores) == len(scores) > 0
        np.testing.assert_array_equal(got.classes, classes)
        np.testing.assert_allclose(got.scores, scores, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.boxes, boxes, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(boxes).max()))
    assert len(want) == 6                     # the tail padded to 2


def test_ap_dicts_match_jax(eval_run):
    got, want = eval_run["result"], eval_run["want"]
    assert got.keys() == want.keys() == {"Car"}
    assert got["Car"].keys() == want["Car"].keys()
    for bucket in want["Car"]:
        g, w = got["Car"][bucket], want["Car"][bucket]
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=0, abs=1e-12), (bucket, k)
    assert got["Car"]["all"]["num_gt"] == 10
    assert got["Car"]["all"]["num_det"] > 0


def test_run_eval_leaves_the_model_in_train_mode(eval_run):
    assert eval_run["model"].training
