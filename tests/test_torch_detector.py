"""PyTorch port: the whole serving slice against the JAX package.

Two different synthetic frames, assembled once by the host feed (which
``test_torch_native.py`` holds bit-identical across the packages), go
through JAX's forward (``MVXNetPM`` under ``make_apply``, one sample at a
time) and ``decode_predictions``, and through the port's ``Detector``
with the same weights (``models/weights.load_jax_params``).

Both models run in float64 (JAX under ``jax.enable_x64``, whose column
merge is then the XLA composition, compiled without XLA's algebraic
simplifier: it turns divisions by constants into multiplications, which
the untrained model's norms amplify from one float32 ulp in the image
transform to ~1e-5 in the maps; eager JAX and the port both divide, and
agree to ~1e-11).  Both detectors hand float32
maps to decoding, as they do in serving.  Detections must agree in
count, order and class; scores to 1e-6 and boxes to 1e-5 (float32
decoding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.eval.decode import (
    decode_predictions as jax_decode_predictions,
)
from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.step import _model_inputs
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.weights import load_jax_params
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.serve import Detector

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0)
CFG = Config(**KW)


def _run_dividing(fn, *args):
    """``fn(*args)`` compiled without XLA's algebraic simplifier."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return compiled(*args)


def _random_params(model, jcfg, rng):
    """Random weights in the JAX model's parameter tree, from numpy:
    kernels normal(0, 1/fan_in), biases and folded norms random too."""
    P, V = jcfg.max_points, jcfg.max_voxels
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, P, 6)),
        jnp.zeros((1, P), bool), jnp.full((1, P), V, jnp.int32),
        jnp.zeros((1, V), jnp.int32), jnp.zeros((1, V, 3), jnp.int32),
        jnp.zeros((1, V), bool), jnp.zeros((1, *jcfg.image_size, 3)))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape)
        return rng.normal(0, 0.1, leaf.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: draw(p, a).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def slice_run():
    jcfg = JaxConfig(**KW)
    rng = np.random.default_rng(0)
    model = JaxMVXNetPM(
        grid_shape=jcfg.voxel_shape, image_size=jcfg.image_size,
        anchors_per_loc=jcfg.anchors_per_loc,
        image_min_side=jcfg.image_min_side,
        samples_per_voxel=jcfg.samples_per_voxel, cml_mode=jcfg.cml_mode)
    params = _random_params(model, jcfg, rng)
    frames = [synthetic_frame(rng, CFG, num_cars=2, num_points=n)[:3]
              for n in (900, 1500)]

    port = build_model(CFG, seed=None, device="cpu")
    load_jax_params(port, params)
    det = Detector(CFG, port.double())
    arrays = det.assemble(frames)
    pts, nums, imgs = arrays

    anchors = jnp.asarray(create_anchors(CFG.feature_map_shape,
                                         CFG.velo_range, CFG.anchor_sizes))
    with jax.enable_x64(True):
        b = _run_dividing(lambda p, n, i: jax_batch(
            p, n, i, jnp.zeros((2, 1, 7)), jnp.zeros((2, 1), bool), jcfg),
            jnp.asarray(pts, jnp.float64), jnp.asarray(nums),
            jnp.asarray(imgs, jnp.float64))
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        score, reg = _run_dividing(make_apply(model, jcfg), p64,
                                   *_model_inputs(b, True))
    decode = jax.jit(lambda s, r: jax_decode_predictions(s, r, anchors))
    want = [decode(jnp.asarray(s, jnp.float32), jnp.asarray(r, jnp.float32))
            for s, r in zip(score, reg)]
    yield dict(det=det, frames=frames, arrays=arrays, want=want,
               maps=(np.asarray(score), np.asarray(reg)))
    det.close()


def test_detector_matches_jax_forward_and_decode(slice_run):
    got = slice_run["det"].detect_batch(*slice_run["arrays"])
    assert len(got) == 2
    for g, w in zip(got, slice_run["want"]):
        v = np.asarray(w.valid)
        assert len(g.scores) == v.sum() > 0
        np.testing.assert_array_equal(g.classes, np.asarray(w.classes)[v])
        np.testing.assert_allclose(g.scores, np.asarray(w.scores)[v],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.boxes, np.asarray(w.boxes)[v],
                                   rtol=0, atol=1e-5)
    # the two frames differ
    assert not np.array_equal(got[0].boxes, got[1].boxes)


@torch.no_grad()
def test_detector_maps_match_jax(slice_run):
    from mvxnet_makise_tpu_torch.train.step import (
        frames_to_batch,
        model_inputs,
    )

    det = slice_run["det"]
    pts, nums, imgs = (torch.from_numpy(a) for a in slice_run["arrays"])
    b = frames_to_batch(pts.double(), nums, imgs.double(), CFG)
    score, reg = det.model(*model_inputs(b))
    want_s, want_r = slice_run["maps"]
    np.testing.assert_allclose(score.numpy(), want_s, rtol=0, atol=1e-9)
    np.testing.assert_allclose(reg.numpy(), want_r, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(want_r).max()))


def test_detect_frames_and_stream_keep_order(slice_run):
    det, frames = slice_run["det"], slice_run["frames"]
    direct = det.detect_batch(*slice_run["arrays"])
    assert all(np.array_equal(a.boxes, b.boxes) for a, b in
               zip(det.detect_frames(frames), direct))
    # three batches (2, 2, 1) of the frames in a new order
    order = [1, 0, 0, 1, 1]
    streamed = list(det.detect_stream([frames[i] for i in order],
                                      batch_size=2))
    assert len(streamed) == len(order)
    for i, s in zip(order, streamed):
        assert len(s.scores) == len(direct[i].scores)
        np.testing.assert_allclose(s.scores, direct[i].scores, atol=1e-6)
        np.testing.assert_allclose(s.boxes, direct[i].boxes, atol=1e-5)
