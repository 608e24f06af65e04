"""PyTorch port: the LiDAR-only detector (``with_images=False``; the
``--lidar-only`` of ``configs/lidar_only.yaml``) against the JAX package.

JAX's LiDAR-only model is ``VoxelNetBranchPM`` on the 7 LiDAR channels
(``train/loop.build_model_and_state(cfg, with_images=False)``), its
parameters at the root of the tree, its point features computed outside
the model (``train/step._model_inputs``).  The port's
``build_model(cfg, with_images=False)`` is the same module and
``load_jax_params`` loads the same tree.

In float64 (JAX under ``jax.enable_x64``, compiled without XLA's
algebraic simplifier, as ``tests/test_torch_detector.py`` explains): the
maps, and one train step's loss, metrics, gradients and AdamW update, to
1e-8 relative; ``Detector``'s detections (float32 decoding) and
``run_eval``'s AP dicts as the fused model's tests hold them.  Then the
three CLIs with ``--lidar-only`` on a small KITTI tree whose images are
never read: train with the val AP, ``tools.evaluate`` (the same AP) and
``tools.detect``, and a checkpoint that restores the LiDAR-only model.

Under ``use_bf16`` both sides compute in float32 with bfloat16-rounded
weights: the maps and one train step's loss and master gradients are held
to float32 tolerances (``BF16_MAPS_TOL``, ``BF16_GRAD_TOL``).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.eval import runner as jax_runner
from mvxnet_makise_tpu.eval.decode import (
    decode_predictions as jax_decode_predictions,
)
from mvxnet_makise_tpu.models.voxelnet_pm import (
    VoxelNetBranchPM as JaxBranch,
)
from mvxnet_makise_tpu.train.loss import voxel_loss as jax_voxel_loss
from mvxnet_makise_tpu.train.state import TrainState as JaxTrainState
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.state import make_optimizer as jax_optimizer
from mvxnet_makise_tpu.train.step import _assign_batch as jax_assign_batch
from mvxnet_makise_tpu.train.state import cast_for_compute as jax_cast
from mvxnet_makise_tpu.train.step import _model_inputs
from mvxnet_makise_tpu.train.step import cast_batch_for_compute as jax_castb
from mvxnet_makise_tpu.train.step import compute_loss as jax_compute_loss
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config, load_config
from mvxnet_makise_tpu_torch.data.kitti import load_dataset
from mvxnet_makise_tpu_torch.eval.runner import run_eval
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.voxelnet_pm import VoxelNetBranchPM
from mvxnet_makise_tpu_torch.models.weights import (
    lidar_branch_state,
    load_jax_params,
)
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.serve import Detector
from mvxnet_makise_tpu_torch.tools import detect, evaluate
from mvxnet_makise_tpu_torch.tools import train as train_cli
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.loop import (
    build_model_and_state,
    collate,
    preprocess_train_frame,
)
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    forward,
    frames_to_batch,
    make_train_step,
)
from _jax_ref import jit_dividing, jit_without_algsimp
from test_torch_eval_runner import _frames
from test_torch_tools import _yaml, tree  # noqa: F401  (a fixture)

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0, batch_size=2)
CFG = Config(**KW)
TOL = 1e-8
# use_bf16 (float32 compute, bfloat16-rounded weights) on both sides:
# float32 rounding apart in the maps and the loss; a gradient is rounded
# to bfloat16 once in the port (autograd of the cast), while JAX's
# compiled step rounds some sums of cotangents and drops other
# float32 -> bfloat16 -> float32 conversion pairs, a few bfloat16 steps
# (2^-9 each) apart.  Measured on a CPU: maps 2.4e-5, loss 4.8e-6,
# gradients at most 3.1e-3 (5e-5 in float32 alone).
BF16_TRUNK = dict(rpn_channels=(32, 32, 64), rpn_extra=(0, 0, 0),
                  rpn_deconv_channels=32)
BF16_MAPS_TOL = 1e-4
BF16_GRAD_TOL = 2 ** -7


def _jax_model():
    return JaxBranch(CFG.voxel_shape, anchors_per_loc=CFG.anchors_per_loc,
                     samples_per_voxel=CFG.samples_per_voxel,
                     cml_mode="column")


def _random_params(model, rng):
    """Random weights in the LiDAR-only parameter tree, from numpy."""
    P, V = CFG.max_points, CFG.max_voxels
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, P, 7)),
        jnp.zeros((1, P), bool), jnp.full((1, P), V, jnp.int32),
        jnp.zeros((1, V), jnp.int32), jnp.zeros((1, V, 3), jnp.int32),
        jnp.zeros((1, V), bool))

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        return rng.normal(0, 0.1, leaf.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: draw(p, a).astype(np.float32), shapes)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module")
def lidar_run():
    """The same weights, frames and voxelizer shuffle on both sides: JAX's
    maps, one step's loss, gradients and update (float64), and the
    port's."""
    rng = np.random.default_rng(0)
    jcfg = JaxConfig(**KW)
    model = _jax_model()
    params = _random_params(model, rng)
    frames, jax_frames = _frames(rng, n=2)
    arrays = [preprocess_train_frame(f, CFG, None, np.random.default_rng(i))
              for i, f in enumerate(frames)]
    pts, nums, imgs, gts, gms, gcs = (t.numpy() for t in collate(
        arrays, torch.device("cpu")))
    key = jax.random.key(7)
    perm = np.stack([np.asarray(jax.random.permutation(k, CFG.max_points))
                     for k in jax.random.split(key, 2)])
    anchors = create_anchors(CFG.feature_map_shape, CFG.velo_range,
                             CFG.anchor_sizes).astype(np.float64)
    apply_fn = make_apply(model, jcfg)

    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)

        def maps(p, pts, nums, imgs):
            batch = jax_batch(pts, nums, imgs, jnp.zeros((2, 1, 7)),
                              jnp.zeros((2, 1), bool), jcfg)
            return apply_fn(p, *_model_inputs(batch, False))

        def loss_fn(p, batch):
            targets = jax_assign_batch(batch, jcfg)
            score, reg = apply_fn(p, *_model_inputs(batch, False))
            losses, metrics = jax.vmap(lambda s, r, t, g: jax_voxel_loss(
                s, r, t, g, jnp.asarray(anchors),
                pos_weight=jcfg.pos_loss_weight,
                neg_weight=jcfg.neg_loss_weight, eps=jcfg.eps,
                mode=jcfg.cls_loss_mode, focal_gamma=jcfg.focal_gamma,
                focal_alpha=jcfg.focal_alpha))(score, reg, targets,
                                               batch.gt_boxes)
            return jnp.mean(losses), jax.tree.map(jnp.mean, metrics)

        def step(p, pts, nums, imgs, gts, gms, gcs):
            batch = jax_batch(pts, nums, imgs, gts, gms, jcfg,
                              shuffle_key=key, gt_classes=gcs)
            return jax.value_and_grad(loss_fn, has_aux=True)(p, batch)

        args64 = (jnp.asarray(pts, jnp.float64), jnp.asarray(nums),
                  jnp.asarray(imgs, jnp.float64))
        score, reg = jit_dividing(maps)(p64, *args64)
        (loss, metrics), grads = jit_dividing(step)(
            p64, *args64, jnp.asarray(gts, jnp.float64),
            jnp.asarray(gms), jnp.asarray(gcs))
        state = JaxTrainState.create(apply_fn, p64, jax_optimizer(jcfg))
        new_params = state.apply_gradients(grads).params
        jax_out = dict(
            score=np.asarray(score), reg=np.asarray(reg), loss=float(loss),
            metrics={k: float(v) for k, v in metrics.items()},
            grads=lidar_branch_state(jax.device_get(grads)["params"]),
            params=lidar_branch_state(jax.device_get(new_params)["params"]))

    port = build_model(CFG, seed=None, device="cpu", with_images=False)
    assert isinstance(port, VoxelNetBranchPM)
    load_jax_params(port, params)
    port = port.double()
    t = [torch.from_numpy(a) for a in (pts, nums, imgs, gts, gms, gcs)]
    with torch.no_grad():
        port_maps = forward(port.eval(), frames_to_batch(
            t[0].double(), t[1], t[2].double(), CFG), CFG, False)
    state = TrainState.create(CFG, port.train())
    before = {k: v.clone() for k, v in port.state_dict().items()}
    batch = frames_to_batch(t[0].double(), t[1], t[2].double(), CFG,
                            gt_boxes=t[3].double(), gt_mask=t[4],
                            gt_classes=t[5], perm=torch.from_numpy(perm))
    out = make_train_step(CFG, torch.from_numpy(anchors),
                          with_images=False)(state, batch)
    return dict(jax=jax_out, port=out, port_maps=port_maps, state=state,
                before=before, params=params, frames=frames,
                jax_frames=jax_frames, arrays=(pts, nums, imgs),
                train_arrays=(pts, nums, imgs, gts, gms, gcs), key=key,
                perm=perm, model=model)


def test_lidar_only_maps_match_jax(lidar_run):
    score, reg = lidar_run["port_maps"]
    assert score.shape == (2, 16, 20, 2) and reg.shape == (2, 16, 20, 14)
    assert _rel(score.numpy(), lidar_run["jax"]["score"]) <= TOL
    assert _rel(reg.numpy(), lidar_run["jax"]["reg"]) <= TOL


def test_lidar_only_train_step_matches_jax(lidar_run):
    """Loss, metrics and every gradient to 1e-8; the parameters after one
    AdamW step where the gradient is far above eps."""
    got, want = lidar_run["port"], lidar_run["jax"]
    assert float(got["num_pos"]) > 0
    np.testing.assert_allclose(float(got["total_loss"]), want["loss"],
                               rtol=TOL)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=TOL, err_msg=k)
    model = lidar_run["state"].model
    grads = {}
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), want["grads"][name]) <= TOL, name
        grads[name] = p.grad.numpy()
    assert len(grads) == len(want["grads"])
    for name, value in model.state_dict().items():
        big = np.abs(grads[name]) > 1e3 * CFG.eps
        np.testing.assert_allclose(value.numpy()[big],
                                   np.asarray(want["params"][name])[big],
                                   rtol=TOL, atol=1e-10, err_msg=name)
        assert not torch.equal(value, lidar_run["before"][name]), name


@pytest.fixture(scope="module")
def lidar_bf16_run(lidar_run):
    """``use_bf16`` on the LiDAR-only model, on both sides float32 compute
    with bfloat16-rounded weights (JAX's ``cast_for_compute`` promoted by
    the float32 point features; the port's ``cast_for_compute``): the
    maps, and one train step's loss and master gradients, on
    ``lidar_run``'s frames and shuffle.  The RPN trunk is cut to one
    convolution per stage (32, 32, 64 wide): with the reference trunk the
    untrained model amplifies float32 rounding to 7 % of a gradient's norm
    (in float32 alone), with the cut one to 5e-5.  JAX is compiled
    without the algebraic simplifier."""
    kw = dict(KW, **BF16_TRUNK, use_bf16=True)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    model = JaxBranch(CFG.voxel_shape, anchors_per_loc=CFG.anchors_per_loc,
                      samples_per_voxel=CFG.samples_per_voxel,
                      cml_mode="column", rpn_trunk=jcfg.rpn_trunk)
    params = _random_params(model, np.random.default_rng(11))
    apply_fn = make_apply(model, jcfg)
    key, arrays = lidar_run["key"], lidar_run["train_arrays"]
    anchors = create_anchors(CFG.feature_map_shape, CFG.velo_range,
                             CFG.anchor_sizes)

    def maps(p, pts, nums, imgs):
        batch = jax_batch(pts, nums, imgs, jnp.zeros((2, 1, 7)),
                          jnp.zeros((2, 1), bool), jcfg)
        return apply_fn(jax_cast(p, True),
                        *_model_inputs(jax_castb(batch, True), False))

    def step(p, pts, nums, imgs, gts, gms, gcs):
        batch = jax_batch(pts, nums, imgs, gts, gms, jcfg,
                          shuffle_key=key, gt_classes=gcs)
        targets = jax_assign_batch(batch, jcfg)
        return jax.value_and_grad(
            lambda q: jax_compute_loss(q, batch, targets, anchors, apply_fn,
                                       jcfg, False), has_aux=True)(p)
    jarrays = [jnp.asarray(a) for a in arrays]
    score, reg = jit_dividing(maps)(params, *jarrays[:3])
    (loss, _), grads = jit_dividing(step)(params, *jarrays)

    port = build_model(cfg, seed=None, device="cpu", with_images=False)
    load_jax_params(port, params)
    t = [torch.from_numpy(a) for a in arrays]
    with torch.no_grad():
        port_maps = forward(port.eval(), frames_to_batch(*t[:3], cfg), cfg,
                            False)
    state = TrainState.create(cfg, port.train())
    batch = frames_to_batch(*t[:3], cfg, gt_boxes=t[3], gt_mask=t[4],
                            gt_classes=t[5],
                            perm=torch.from_numpy(lidar_run["perm"]))
    out = make_train_step(cfg, torch.from_numpy(anchors),
                          with_images=False)(state, batch)
    return dict(jax_maps=(np.asarray(score), np.asarray(reg)),
                port_maps=port_maps, jax_loss=float(loss),
                jax_grads=lidar_branch_state(jax.device_get(grads)["params"]),
                port=out, model=port)


def test_lidar_only_bf16_maps_match_jax(lidar_bf16_run):
    """float32 maps on both sides, to BF16_MAPS_TOL relative."""
    got, want = lidar_bf16_run["port_maps"], lidar_bf16_run["jax_maps"]
    for g, w, name in zip(got, want, ("score", "reg")):
        assert g.dtype == torch.float32 and w.dtype == np.float32, name
        assert _rel(g.numpy(), w) <= BF16_MAPS_TOL, name


def test_lidar_only_bf16_train_step_matches_jax(lidar_bf16_run):
    """The loss to BF16_MAPS_TOL; every float32 master's gradient holds
    bfloat16 values (autograd passes it back through the cast) and sits
    within BF16_GRAD_TOL of JAX's (norm distance over JAX's norm)."""
    got = lidar_bf16_run["port"]
    want = lidar_bf16_run["jax_grads"]
    assert float(got["num_pos"]) > 0
    np.testing.assert_allclose(float(got["total_loss"]),
                               lidar_bf16_run["jax_loss"],
                               rtol=BF16_MAPS_TOL)
    model = lidar_bf16_run["model"]
    for name, p in model.named_parameters():
        g, w = p.grad, np.asarray(want[name], np.float64)
        assert p.dtype == g.dtype == torch.float32, name
        assert torch.equal(g, g.bfloat16().float()), name
        assert (np.linalg.norm(g.double().numpy() - w)
                <= BF16_GRAD_TOL * np.linalg.norm(w)), name
    assert len(want) == len(dict(model.named_parameters()))


def test_lidar_only_detector_matches_jax(lidar_run):
    port = build_model(CFG, seed=None, device="cpu", with_images=False)
    load_jax_params(port, lidar_run["params"])
    det = Detector(CFG, port.double(), with_images=False)
    got = det.detect_batch(*lidar_run["arrays"])
    det.close()
    anchors = jnp.asarray(create_anchors(CFG.feature_map_shape,
                                         CFG.velo_range, CFG.anchor_sizes))
    decode = jax.jit(lambda s, r: jax_decode_predictions(s, r, anchors))
    n_boxes = 0
    for g, s, r in zip(got, lidar_run["jax"]["score"],
                       lidar_run["jax"]["reg"]):
        w = decode(jnp.asarray(s, jnp.float32), jnp.asarray(r, jnp.float32))
        v = np.asarray(w.valid)
        assert len(g.scores) == v.sum()
        np.testing.assert_array_equal(g.classes, np.asarray(w.classes)[v])
        np.testing.assert_allclose(g.scores, np.asarray(w.scores)[v],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.boxes, np.asarray(w.boxes)[v],
                                   rtol=0, atol=1e-5)
        n_boxes += len(g.scores)
    assert n_boxes > 0


def test_lidar_only_run_eval_matches_jax(lidar_run):
    """Five frames at batch 2, the images never used: AP dicts equal."""
    port = build_model(CFG, seed=None, device="cpu", with_images=False)
    load_jax_params(port, lidar_run["params"])
    frames, jax_frames = _frames(np.random.default_rng(3))
    got = run_eval(CFG, frames, port.double(), batch_size=2,
                   with_images=False)
    decoded = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax, "jit", jit_without_algsimp(decoded))
        want = jax_runner.run_eval(JaxConfig(**KW), jax_frames,
                                   lidar_run["params"], lidar_run["model"],
                                   False, batch_size=2)
    assert len(decoded) == 3
    assert got["Car"].keys() == want["Car"].keys()
    for bucket in want["Car"]:
        for k, w in want["Car"][bucket].items():
            assert got["Car"][bucket][k] == pytest.approx(
                w, rel=0, abs=1e-12), (bucket, k)
    assert got["Car"]["all"]["num_det"] > 0


def test_lidar_only_checkpoint_restores(tmp_path):
    """Checkpoints hold the LiDAR-only model's float32 masters (under
    ``use_bf16`` too) and restore into a fresh state and a Detector."""
    cfg = CFG.replace(use_bf16=True, checkpoint_dir=str(tmp_path))
    model, state = build_model_and_state(cfg, device="cpu", seed=1,
                                         with_images=False)
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    saved = torch.load(os.path.join(tmp_path, "epoch1"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved["model"].values())
    assert not any(k.startswith("head.") for k in saved["model"])
    _, other = build_model_and_state(cfg, device="cpu", seed=2,
                                     with_images=False)
    ckpt.restore_checkpoint(str(tmp_path), 1, other)
    det = Detector.create(cfg, device="cpu", with_images=False)
    for k, v in model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
        assert torch.equal(det.model.state_dict()[k], v), k


def test_lidar_only_clis(tree, tmp_path, capsys):
    """``tools.train --lidar-only`` (val AP each epoch), ``tools.evaluate
    --lidar-only`` (the loop's AP from the checkpoint) and ``tools.detect
    --lidar-only`` on a tree whose frames load without their images."""
    root, _ = tree
    cfg_path = _yaml(tmp_path / "tiny.yaml",
                     checkpoint_dir=str(tmp_path / "ck"))
    cfg = load_config(cfg_path)
    assert all(f.image is None for f in load_dataset(
        root, "val", cfg, load_images=False))
    dev = ["--lidar-only", "--config", cfg_path, "--device", "cpu"]
    assert train_cli.main([root, "-n", "1", "--eval-every", "1",
                           *dev]) == 0
    loop = [ln for ln in capsys.readouterr().out.splitlines()
            if " val Car: " in ln]
    assert len(loop) == 1
    saved = torch.load(str(tmp_path / "ck" / "epoch1"), weights_only=True)
    assert set(saved["model"]) == set(VoxelNetBranchPM(
        7, CFG.voxel_shape).state_dict())
    assert evaluate.main([root, "-r", "1", *dev]) == 0
    all_line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("Car all:")]

    def values(line):
        return dict(re.findall(r"(AP|R|gt)=([\d.]+)", line))
    assert values(all_line[0]) == values(loop[0])
    results = str(tmp_path / "results")
    assert detect.main([root, "-o", results, "-r", "1", "--batch", "2",
                        "--score-threshold", "0.0", *dev]) == 0
    assert sorted(os.listdir(results)) == ["000004.txt", "000005.txt"]
    for name in os.listdir(results):
        with open(os.path.join(results, name)) as f:
            lines = [ln.split() for ln in f.read().splitlines()]
        assert lines and all(len(p) == 16 and p[0] == "Car" for p in lines)
