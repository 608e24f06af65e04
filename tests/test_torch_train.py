"""PyTorch port: the training slice against the JAX package.

One train step on the same two synthetic frames, the same weights
(``models/weights.load_jax_params``) and the same voxelizer shuffle
(JAX's ``jax.random.permutation`` of each frame, handed to the port as
``perm``), in both CML modes: ``"column"`` (K1's plain version and its
autograd) and ``"dense3d"`` with ``scatter_backend="pallas"`` (K4's plain
version; JAX runs its Pallas kernel in interpret mode).

Both sides run in float64 (JAX under ``jax.enable_x64``, compiled without
XLA's algebraic simplifier, as ``tests/test_torch_detector.py`` explains).
JAX's ``compute_loss`` casts the maps to float32 before the loss; the
port keeps at least float32, so a float64 model keeps float64.  The JAX
side here is therefore ``make_train_step``'s body with the loss taken in
float64: its targets, model, ``voxel_loss`` and optimizer, unchanged.
Loss, metrics and the gradient of every trainable parameter agree to
1e-8 relative, and so do the parameters after one AdamW step where the
gradient is far above AdamW's eps (its first step is about lr*sign(g)).

Also: the extractor stays bit-unchanged, the cosine schedule equals
optax's, a non-finite loss skips the update, a checkpoint round-trips and
resumes, and ``tools.train`` runs on the CPU.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.data.kitti import KittiFrame
from mvxnet_makise_tpu.geometry.calib import Calib as JaxCalib
from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
from mvxnet_makise_tpu.train.loop import (
    preprocess_train_frame as jax_preprocess,
)
from mvxnet_makise_tpu.train.loss import voxel_loss as jax_voxel_loss
from mvxnet_makise_tpu.train.state import TrainState as JaxTrainState
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.state import make_optimizer as jax_optimizer
from mvxnet_makise_tpu.train.step import _assign_batch as jax_assign_batch
from mvxnet_makise_tpu.train.step import _model_inputs
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.kitti import KittiFrame as Frame
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.weights import (
    load_jax_params,
    mvxnet_state,
)
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.tools import train as train_cli
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.loop import (
    collate,
    preprocess_train_frame,
)
from mvxnet_makise_tpu_torch.train.state import TrainState, lr_schedule
from mvxnet_makise_tpu_torch.train.step import (
    frames_to_batch,
    make_eval_step,
    make_train_step,
    model_inputs,
)
from _jax_ref import jit_dividing

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0, batch_size=2)
CFG = Config(**KW)


def _random_params(model, jcfg, rng):
    """Random weights in the JAX model's parameter tree, from numpy."""
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


def _frames(cfg, seed=0, **kw):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate((900, 1500)):
        pts, calib, image, boxes = synthetic_frame(rng, cfg, num_cars=3,
                                                   num_points=n, **kw)
        out.append(Frame(f"f{i}", pts, image, calib, {"Car": boxes}))
    return out


def _arrays(cfg, frames):
    return [preprocess_train_frame(f, cfg, None, np.random.default_rng(i))
            for i, f in enumerate(frames)]


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module", params=["column", "dense3d"])
def step_run(request):
    """One step of each side; returns what they computed."""
    mode = request.param
    kw = dict(KW, cml_mode=mode,
              scatter_backend="pallas" if mode == "dense3d" else "auto")
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    rng = np.random.default_rng(0)
    model = JaxMVXNetPM(
        grid_shape=jcfg.voxel_shape, image_size=jcfg.image_size,
        anchors_per_loc=jcfg.anchors_per_loc,
        image_min_side=jcfg.image_min_side,
        samples_per_voxel=jcfg.samples_per_voxel, cml_mode=jcfg.cml_mode,
        scatter_backend=jcfg.scatter_backend)
    params = _random_params(model, jcfg, rng)
    pts, nums, imgs, gts, gms, gcs = (t.numpy() for t in collate(
        _arrays(cfg, _frames(cfg)), torch.device("cpu")))
    key = jax.random.key(5)
    perm = np.stack([np.asarray(jax.random.permutation(k, cfg.max_points))
                     for k in jax.random.split(key, 2)])
    anchors = create_anchors(cfg.feature_map_shape, cfg.velo_range,
                             cfg.anchor_sizes).astype(np.float64)

    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        apply_fn = make_apply(model, jcfg)

        def loss_fn(p, batch):
            targets = jax_assign_batch(batch, jcfg)
            score, reg = apply_fn(p, *_model_inputs(batch, True))
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

        (loss, metrics), grads = jit_dividing(step)(
            p64, jnp.asarray(pts, jnp.float64), jnp.asarray(nums),
            jnp.asarray(imgs, jnp.float64), jnp.asarray(gts, jnp.float64),
            jnp.asarray(gms), jnp.asarray(gcs))
        state = JaxTrainState.create(apply_fn, p64, jax_optimizer(jcfg))
        new_params = state.apply_gradients(grads).params
        jax_out = dict(loss=float(loss),
                       metrics={k: float(v) for k, v in metrics.items()},
                       grads=mvxnet_state(jax.device_get(grads)["params"]),
                       params=mvxnet_state(
                           jax.device_get(new_params)["params"]))

    port = build_model(cfg, seed=None, device="cpu")
    load_jax_params(port, params)
    port = port.double().train()
    tstate = TrainState.create(cfg, port)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    batch = frames_to_batch(
        torch.from_numpy(pts).double(), torch.from_numpy(nums),
        torch.from_numpy(imgs).double(), cfg,
        gt_boxes=torch.from_numpy(gts).double(),
        gt_mask=torch.from_numpy(gms), gt_classes=torch.from_numpy(gcs),
        perm=torch.from_numpy(perm))
    out = make_train_step(cfg, torch.from_numpy(anchors))(tstate, batch)
    return dict(mode=mode, jax=jax_out, port=out, state=tstate,
                before=before)


def test_train_step_loss_and_metrics_match_jax(step_run):
    got, want = step_run["port"], step_run["jax"]
    assert float(got["num_pos"]) > 0
    assert int(got["skipped_nonfinite"]) == 0
    np.testing.assert_allclose(float(got["total_loss"]), want["loss"],
                               rtol=1e-8)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-8, err_msg=k)


def test_train_step_gradients_match_jax(step_run):
    """Every trainable parameter's gradient, each to 1e-8 of its largest
    value; the CML's conv1 and everything before it included."""
    model = step_run["state"].model
    want = step_run["jax"]["grads"]
    checked = 0
    for name, p in model.named_parameters():
        if "extractor" in name:
            assert p.grad is None
            continue
        assert p.grad is not None, name
        assert _rel(p.grad.numpy(), np.asarray(want[name])) <= 1e-8, name
        checked += 1
    assert checked == len([k for k in want if "extractor" not in k])
    conv1 = model.backbone.cml.conv1.conv
    assert conv1.weight.grad.abs().max() > 0
    assert model.head.fusion.fcn1.fc.weight.grad.abs().max() > 0


def test_train_step_update_matches_jax(step_run):
    """Parameters after one AdamW step, where |g| is far above eps; the
    frozen extractor bit-unchanged."""
    state = step_run["state"]
    assert state.step == 1
    want = step_run["jax"]["params"]
    grads = dict(state.model.named_parameters())
    for name, value in state.model.state_dict().items():
        if "extractor" in name:
            assert torch.equal(value, step_run["before"][name]), name
            continue
        g = grads[name].grad.numpy()
        big = np.abs(g) > 1e3 * CFG.eps
        np.testing.assert_allclose(value.numpy()[big],
                                   np.asarray(want[name])[big], rtol=1e-8,
                                   atol=1e-10, err_msg=name)
        assert not torch.equal(value, step_run["before"][name]), name


def test_preprocess_matches_jax():
    frame = _frames(CFG, seed=3)[0]
    got = preprocess_train_frame(frame, CFG, None, np.random.default_rng(9))
    c = frame.calib
    jframe = KittiFrame(frame_id="f", points=frame.points,
                        image=frame.image,
                        calib=JaxCalib(c.velo_to_cam, c.P2, c.R0),
                        boxes=frame.boxes, bbox2d={}, difficulty={})
    want, want_cls = jax_preprocess(jframe, JaxConfig(**KW), None,
                                    np.random.default_rng(9))
    np.testing.assert_array_equal(got.points, want.points)
    assert got.num_points == int(want.num_points)
    for name in ("image", "gt_boxes", "gt_mask"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.gt_classes, want_cls)


@pytest.mark.parametrize("warmup,decay", [(5, 20), (4, 2), (0, 10)])
def test_cosine_schedule_matches_optax(warmup, decay):
    cfg = CFG.replace(lr_schedule="cosine", lr_warmup_steps=warmup,
                      lr_decay_steps=decay)
    want = optax.warmup_cosine_decay_schedule(
        init_value=cfg.learning_rate / 25, peak_value=cfg.learning_rate,
        warmup_steps=warmup, decay_steps=max(decay, warmup + 1),
        end_value=cfg.learning_rate / 20)
    got = lr_schedule(cfg)
    # optax evaluates in float32: (init - peak) * frac + peak loses a few
    # ulps to cancellation
    for count in range(30):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-5, err_msg=str(count))
    assert lr_schedule(CFG)(17) == CFG.learning_rate


@pytest.fixture(scope="module")
def small_batch():
    """Float32 weights and a batch for the step's own behaviour; the cars
    are axis-aligned, so the batch has positive anchors."""
    weights = build_model(CFG, seed=1, device="cpu").state_dict()
    tensors = collate(_arrays(CFG, _frames(CFG, seed=1, yaw_range=(0, 0))),
                      torch.device("cpu"))
    anchors = torch.from_numpy(create_anchors(
        CFG.feature_map_shape, CFG.velo_range, CFG.anchor_sizes))
    return weights, tensors, anchors


def _model(weights, seed=None):
    model = build_model(CFG, seed=seed, device="cpu")
    if weights is not None:
        model.load_state_dict(weights)
    return model.train()


def _batch(tensors, perm_seed=0):
    pts, nums, imgs, gts, gms, gcs = tensors
    g = torch.Generator().manual_seed(perm_seed)
    perm = torch.stack([torch.randperm(CFG.max_points, generator=g)
                        for _ in range(2)])
    return frames_to_batch(pts, nums, imgs, CFG, gt_boxes=gts, gt_mask=gms,
                           gt_classes=gcs, perm=perm)


def test_nonfinite_loss_skips_the_update(small_batch):
    """NaN anchors make the regression loss NaN: the step leaves the
    parameters, AdamW's state and the step count (so the schedule) as they
    were.  (NaN features do not reach the loss: the per-voxel max maps them
    to 0, in JAX as here.)"""
    weights, tensors, anchors = small_batch
    model = _model(weights)
    cfg = CFG.replace(lr_schedule="cosine")
    state = TrainState.create(cfg, model)
    bad = anchors.clone()
    bad[..., 2] = float("nan")
    metrics = make_train_step(cfg, bad)(state, _batch(tensors))
    assert float(metrics["num_pos"]) > 0
    assert int(metrics["skipped_nonfinite"]) == 1
    assert not torch.isfinite(metrics["total_loss"])
    assert state.step == 0 and not state.optimizer.state
    for k, v in model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    metrics = make_train_step(cfg, anchors)(state, _batch(tensors))
    assert int(metrics["skipped_nonfinite"]) == 0
    assert state.step == 1 and state.optimizer.state
    assert state.optimizer.param_groups[0]["lr"] == lr_schedule(cfg)(0)


def test_eval_step_returns_the_models_maps(small_batch):
    weights, tensors, _ = small_batch
    model = _model(weights)
    batch = _batch(tensors)
    score, reg = make_eval_step(CFG)(model, batch)
    assert not score.requires_grad and score.dtype == torch.float32
    with torch.no_grad():
        want = model(*model_inputs(batch))
    assert torch.equal(score, want[0]) and torch.equal(reg, want[1])


def test_checkpoint_round_trip_and_resume(small_batch, tmp_path):
    weights, tensors, anchors = small_batch
    step = make_train_step(CFG, anchors)
    model = _model(weights)
    state = TrainState.create(CFG, model)
    step(state, _batch(tensors))
    path = ckpt.save_checkpoint(str(tmp_path), 1, state)
    assert os.path.basename(path) == "epoch1"
    saved = {k: v.clone() for k, v in model.state_dict().items()}

    other = _model(None, seed=2)
    restored = ckpt.restore_checkpoint(str(tmp_path), 1,
                                       TrainState.create(CFG, other))
    assert restored.step == 1
    for k, v in other.state_dict().items():
        assert torch.equal(v, saved[k]), k
    a = state.optimizer.state_dict()["state"]
    b = restored.optimizer.state_dict()["state"]
    assert a.keys() == b.keys()
    for i in a:
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k])
            assert a[i][k].device == b[i][k].device
    # resuming gives the step the original run takes next
    m1 = step(state, _batch(tensors, perm_seed=1))
    m2 = step(restored, _batch(tensors, perm_seed=1))
    assert float(m1["total_loss"]) == float(m2["total_loss"])
    for (k, v), w in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(v, w), k

    for e in (2, 3):
        ckpt.save_checkpoint(str(tmp_path), e, restored)
    assert ckpt.latest_epoch(str(tmp_path)) == 3
    ckpt.prune_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["epoch2", "epoch3"]


def test_train_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``tools.train --synthetic 2 -n 1``, then ``-n 2 -r 1``: epochs 2
    and 3 continue from epoch 1's checkpoint; then ``-n 3 -r 3`` with a
    spent time budget stops after epoch 4 and keeps the last two."""
    monkeypatch.chdir(tmp_path)
    with open("tiny.yaml", "w") as f:
        for k, v in KW.items():
            f.write(f"{k}: {list(v) if isinstance(v, tuple) else v}\n")
    args = ["--synthetic", "2", "--config", "tiny.yaml", "--device", "cpu"]
    assert train_cli.main(args + ["-n", "1"]) == 0
    assert train_cli.main(args + ["-n", "2", "-r", "1"]) == 0
    out = capsys.readouterr().out
    assert "epoch 1 done | step 1" in out
    assert "epoch 3 done | step 3" in out
    assert sorted(os.listdir("checkpoints")) == ["epoch1", "epoch2",
                                                 "epoch3"]
    saved = torch.load("checkpoints/epoch3", weights_only=True)
    assert saved["step"] == 3 and saved["epoch"] == 3
    assert train_cli.main(args + ["-n", "3", "-r", "3", "--max-seconds",
                                  "0", "--keep-last", "2"]) == 0
    out = capsys.readouterr().out
    assert "epoch 4 done | step 4" in out and "epoch 5" not in out
    assert "time budget" in out
    assert sorted(os.listdir("checkpoints")) == ["epoch3", "epoch4"]
    with pytest.raises(SystemExit):
        train_cli.main(["kitti_dataset"])
    assert "dataroot missing" in capsys.readouterr().err
