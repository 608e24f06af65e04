"""PyTorch port: ``fusion_mode="voxel"`` (``MVXNetVoxelFusion``, the MVX-Net
paper's VoxelFusion) against the JAX package's module.

The same weights (``models/weights.load_jax_params`` of JAX's voxel tree:
``svfe, fcn, extractor, imfuse1, imfuse2, mix, cml, rpn``) and the same
frames.  JAX's model takes the (V, T, 9) slot tensor of JAX's voxelizer;
the port's takes the point-major inputs every other fused model takes.
JAX's train step cannot feed it (``train/step._model_inputs`` hands any
slot-mode model the point-fusion arguments), so the JAX side here calls
the module's ``apply`` (through ``make_apply``) on the slot tensor
itself, with JAX's ``voxel_loss`` after it.

One frame holds a point whose x, y and z are all 0: the voxelizer keeps
it, and JAX's mean image projection does not count it.

In float64 (JAX under ``jax.enable_x64``, compiled without XLA's
algebraic simplifier, as ``tests/test_torch_detector.py`` explains): the
maps of a shuffled training batch, and one train step's loss, metrics and
every trainable gradient, to 1e-8 relative (measured on a CPU: maps
8.3e-13).  The extractor is frozen: the port runs it without autograd and
JAX's gradient is taken over the other parameters.  Under ``use_bf16``,
by ``tests/test_torch_bf16.py``'s rule (the port's distance from JAX's
bfloat16 maps at most twice JAX's own bfloat16-to-float32 distance, the
RPN trunk cut): measured score 0.22 against 0.23, reg 1.2 against 2.1.
Then a checkpoint round trip, and ``tools.train``, ``tools.evaluate`` and
``tools.detect`` on a tiny YAML with ``fusion_mode: voxel``;
``tools.export_checkpoint`` refuses the checkpoint.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.models.mvxnet import (
    MVXNetVoxelFusion as JaxVoxelFusion,
)
from mvxnet_makise_tpu.train.loss import voxel_loss as jax_voxel_loss
from mvxnet_makise_tpu.train.state import cast_for_compute as jax_cast
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.step import _assign_batch as jax_assign_batch
from mvxnet_makise_tpu.train.step import cast_batch_for_compute as jax_castb
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config, load_config
from mvxnet_makise_tpu_torch.models.mvxnet import (
    MVXNetVoxelFusion,
    build_model,
)
from mvxnet_makise_tpu_torch.models.weights import (
    load_jax_params,
    voxel_fusion_state,
)
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.serve import Detector
from mvxnet_makise_tpu_torch.tools import detect, evaluate
from mvxnet_makise_tpu_torch.tools import export_checkpoint
from mvxnet_makise_tpu_torch.tools import train as train_cli
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.loop import build_model_and_state, collate
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    forward,
    frames_to_batch,
    make_train_step,
)
from _jax_ref import jit_dividing
from test_torch_tools import _yaml, tree  # noqa: F401  (a fixture)
from test_torch_train import _arrays, _frames, _rel

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0, batch_size=2,
          fusion_mode="voxel")
CFG = Config(**KW)
TOL = 1e-8
BF16_TRUNK = dict(rpn_channels=(32, 32, 64), rpn_extra=(0, 0, 0),
                  rpn_deconv_channels=32)
BF16_FACTOR = 2.0


def _jax_model(jcfg):
    return JaxVoxelFusion(grid_shape=jcfg.voxel_shape,
                          image_size=jcfg.image_size,
                          anchors_per_loc=jcfg.anchors_per_loc,
                          image_min_side=jcfg.image_min_side,
                          rpn_trunk=jcfg.rpn_trunk)


def _random_params(model, jcfg, rng):
    """Random weights in the voxel model's parameter tree, from numpy."""
    V, T = jcfg.max_voxels, jcfg.samples_per_voxel
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, V, T, 9)),
        jnp.zeros((1, V, 3), jnp.int32), jnp.zeros((1, V), bool),
        jnp.zeros((1, *jcfg.image_size, 3)))

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


def _training_arrays(cfg):
    """Two training frames; the first point of frame 0 moved to x = y =
    z = 0 with its (row, col) kept."""
    pts, nums, imgs, gts, gms, gcs = (t.numpy() for t in collate(
        _arrays(cfg, _frames(cfg)), torch.device("cpu")))
    pts[0, 0, :3] = 0.0
    pts[0, 0, 4:6] = (30.0, 40.0)
    return pts, nums, imgs, gts, gms, gcs


def _split(params):
    """(the extractor's subtree, everything else)."""
    p = dict(params["params"])
    return p.pop("extractor"), p


@pytest.fixture(scope="module")
def voxel_run():
    """Maps and one train step of each side in float64, on the same
    weights, frames and voxelizer shuffle."""
    jcfg = JaxConfig(**KW)
    model = _jax_model(jcfg)
    params = _random_params(model, jcfg, np.random.default_rng(0))
    arrays = _training_arrays(CFG)
    pts, nums, imgs, gts, gms, gcs = arrays
    key = jax.random.key(5)
    perm = np.stack([np.asarray(jax.random.permutation(k, CFG.max_points))
                     for k in jax.random.split(key, 2)])
    anchors = create_anchors(CFG.feature_map_shape, CFG.velo_range,
                             CFG.anchor_sizes).astype(np.float64)
    apply_fn = make_apply(model, jcfg)

    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        ext, rest = _split(p64)

        def loss_fn(rest, ext, batch):
            targets = jax_assign_batch(batch, jcfg)
            score, reg = apply_fn({"params": dict(rest, extractor=ext)},
                                  batch.voxels, batch.coords, batch.vmask,
                                  batch.images)
            losses, metrics = jax.vmap(lambda s, r, t, g: jax_voxel_loss(
                s, r, t, g, jnp.asarray(anchors),
                pos_weight=jcfg.pos_loss_weight,
                neg_weight=jcfg.neg_loss_weight, eps=jcfg.eps,
                mode=jcfg.cls_loss_mode, focal_gamma=jcfg.focal_gamma,
                focal_alpha=jcfg.focal_alpha))(score, reg, targets,
                                               batch.gt_boxes)
            return (jnp.mean(losses),
                    (jax.tree.map(jnp.mean, metrics), score, reg))

        def step(rest, ext, pts, nums, imgs, gts, gms, gcs):
            batch = jax_batch(pts, nums, imgs, gts, gms, jcfg,
                              shuffle_key=key, gt_classes=gcs)
            return (jax.value_and_grad(loss_fn, has_aux=True)(
                rest, ext, batch), batch.voxels)

        ((loss, (metrics, score, reg)), grads), voxels = jit_dividing(step)(
            rest, ext, jnp.asarray(pts, jnp.float64),
            jnp.asarray(nums), jnp.asarray(imgs, jnp.float64),
            jnp.asarray(gts, jnp.float64), jnp.asarray(gms),
            jnp.asarray(gcs))
        grads = jax.device_get(grads)
        jax_out = dict(
            score=np.asarray(score), reg=np.asarray(reg), loss=float(loss),
            metrics={k: float(v) for k, v in metrics.items()},
            voxels=np.asarray(voxels),
            grads={k: v for k, v in voxel_fusion_state(
                dict(grads, extractor=jax.device_get(ext))).items()
                if not k.startswith("extractor.")})

    port = build_model(CFG, seed=None, device="cpu")
    assert isinstance(port, MVXNetVoxelFusion)
    load_jax_params(port, params)
    port = port.double().train()
    t = [torch.from_numpy(a) for a in arrays]
    batch = frames_to_batch(t[0].double(), t[1], t[2].double(), CFG,
                            gt_boxes=t[3].double(), gt_mask=t[4],
                            gt_classes=t[5], perm=torch.from_numpy(perm))
    with torch.no_grad():
        port_maps = forward(port, batch, CFG, True)
        rc = port.voxel_points(batch.sorted_points, batch.sorted_kept,
                               batch.sorted_seg, batch.counts,
                               torch.float64)
    state = TrainState.create(CFG, port)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    out = make_train_step(CFG, torch.from_numpy(anchors))(state, batch)
    return dict(jax=jax_out, port=out, port_maps=port_maps, state=state,
                before=before, params=params, arrays=arrays, batch=batch,
                rc=rc)


def test_voxel_fusion_maps_match_jax(voxel_run):
    score, reg = voxel_run["port_maps"]
    assert score.shape == (2, 16, 20, 2) and reg.shape == (2, 16, 20, 14)
    assert _rel(score.numpy(), voxel_run["jax"]["score"]) <= TOL
    assert _rel(reg.numpy(), voxel_run["jax"]["reg"]) <= TOL


def test_voxel_points_follow_jax_slot_rule(voxel_run):
    """The per-voxel (row, col) equals JAX's mean over the slots whose
    x, y, z are not all zero, computed here from JAX's slot tensor; the
    voxel holding the zero point shows the rule at work."""
    vox = voxel_run["jax"]["voxels"]                    # (B, V, T, 9)
    valid = np.any(vox[..., :3] != 0, axis=-1)
    cnt = np.maximum(valid.sum(-1), 1)[..., None]
    want = (vox[..., 7:9] * valid[..., None]).sum(-2) / cnt
    vmask = voxel_run["batch"].vmask.numpy()
    got = voxel_run["rc"].numpy()
    np.testing.assert_allclose(got[vmask], want[vmask], rtol=1e-12,
                               atol=1e-12)
    zero_slots = np.all(vox[..., :3] == 0, axis=-1) & np.any(
        vox[..., 7:9] != 0, axis=-1)
    assert zero_slots[0].sum() == 1       # the zero point, kept in a slot
    b = voxel_run["batch"]
    kept_cnt = np.maximum(b.counts.numpy(), 1)[..., None]
    with torch.no_grad():
        from mvxnet_makise_tpu_torch.models.voxelnet_pm import segment_sum
        every = segment_sum(b.sorted_points[..., 4:6], b.sorted_seg,
                            b.sorted_kept, b.counts,
                            CFG.samples_per_voxel).numpy() / kept_cnt
    v = np.nonzero(zero_slots[0].any(-1))[0][0]
    assert not np.allclose(every[0, v], got[0, v])


def test_voxel_fusion_train_step_matches_jax(voxel_run):
    """Loss, metrics and every trainable gradient to 1e-8; the fusion
    layers' and the LiDAR encoder's gradients nonzero."""
    got, want = voxel_run["port"], voxel_run["jax"]
    assert float(got["num_pos"]) > 0
    assert int(got["skipped_nonfinite"]) == 0
    np.testing.assert_allclose(float(got["total_loss"]), want["loss"],
                               rtol=TOL)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=TOL, err_msg=k)
    model = voxel_run["state"].model
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith("extractor."):
            assert p.grad is None, name
            continue
        assert _rel(p.grad.numpy(), np.asarray(want["grads"][name])) \
            <= TOL, name
        checked += 1
    assert checked == len(want["grads"])
    for name in ("imfuse1", "imfuse2", "mix", "svfe.vfe1.fcn", "cml.conv1"):
        mod = model.get_submodule(name)
        weight = mod.fc.weight if hasattr(mod, "fc") else mod.conv.weight
        assert weight.grad.abs().max() > 0, name


def test_voxel_fusion_step_leaves_the_extractor(voxel_run):
    state = voxel_run["state"]
    assert state.step == 1
    for name, value in state.model.state_dict().items():
        same = torch.equal(value, voxel_run["before"][name])
        assert same == name.startswith("extractor."), name


def test_voxel_fusion_bf16_maps_match_jax(voxel_run):
    """``use_bf16`` with the RPN trunk cut: the port's bfloat16 maps
    within twice JAX's own bfloat16-to-float32 distance of JAX's
    bfloat16 maps."""
    kw = dict(KW, **BF16_TRUNK, use_bf16=True)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    model = _jax_model(jcfg)
    params = _random_params(model, jcfg, np.random.default_rng(3))
    apply_fn = make_apply(model, jcfg)
    pts, nums, imgs = voxel_run["arrays"][:3]

    def both(p, pts, nums, imgs):
        b = jax_batch(pts, nums, imgs, jnp.zeros((2, 1, 7)),
                      jnp.zeros((2, 1), bool), jcfg)
        cb = jax_castb(b, True)
        return (apply_fn(jax_cast(p, True), cb.voxels, cb.coords, cb.vmask,
                         cb.images),
                apply_fn(p, b.voxels, b.coords, b.vmask, b.images))
    bf16, f32 = jit_dividing(both)(params, jnp.asarray(pts),
                             jnp.asarray(nums), jnp.asarray(imgs))
    port = build_model(cfg, seed=None, device="cpu")
    load_jax_params(port, params)
    with torch.no_grad():
        got = forward(port, frames_to_batch(
            torch.from_numpy(pts), torch.from_numpy(nums),
            torch.from_numpy(imgs), cfg), cfg, True)

    def f64(a):
        if torch.is_tensor(a):
            return a.double().numpy()
        return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)
    for g, b, f, what in zip(got, bf16, f32, ("score", "reg")):
        assert g.dtype == torch.bfloat16, what
        d_port = float(np.abs(f64(g) - f64(b)).max())
        d_jax = float(np.abs(f64(b) - f64(f)).max())
        assert 0 < d_jax and d_port <= BF16_FACTOR * d_jax, (
            what, d_port, d_jax)


def test_voxel_checkpoint_round_trip(tmp_path):
    """A voxel model's checkpoint restores into a fresh state and a
    Detector, and ``tools.export_checkpoint`` refuses it."""
    cfg = CFG.replace(checkpoint_dir=str(tmp_path))
    model, state = build_model_and_state(cfg, device="cpu", seed=1)
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    _, other = build_model_and_state(cfg, device="cpu", seed=2)
    ckpt.restore_checkpoint(str(tmp_path), 1, other)
    det = Detector.create(cfg, device="cpu")
    assert isinstance(det.model, MVXNetVoxelFusion)
    for k, v in model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
        assert torch.equal(det.model.state_dict()[k], v), k
    det.close()
    with pytest.raises(SystemExit) as e:
        export_checkpoint.main(["-r", "1", "--checkpoint-dir",
                                str(tmp_path), "-o",
                                str(tmp_path / "ref.pkl")])
    assert e.value.code != 0
    assert not os.path.exists(tmp_path / "ref.pkl")


def test_voxel_fusion_clis(tree, tmp_path, capsys):
    """``tools.train`` (one epoch with the val AP), ``tools.evaluate``
    (the loop's AP from the checkpoint) and ``tools.detect`` on a YAML
    with ``fusion_mode: voxel``."""
    root, _ = tree
    cfg_path = _yaml(tmp_path / "voxel.yaml", fusion_mode="voxel",
                     checkpoint_dir=str(tmp_path / "ck"))
    assert load_config(cfg_path).fusion_mode == "voxel"
    dev = ["--config", cfg_path, "--device", "cpu"]
    assert train_cli.main([root, "-n", "1", "--eval-every", "1",
                           *dev]) == 0
    loop = [ln for ln in capsys.readouterr().out.splitlines()
            if " val Car: " in ln]
    assert len(loop) == 1
    saved = torch.load(str(tmp_path / "ck" / "epoch1"), weights_only=True)
    assert any(k.startswith("imfuse1.") for k in saved["model"])
    assert evaluate.main([root, "-r", "1", *dev]) == 0
    assert any(ln.startswith("Car all:")
               for ln in capsys.readouterr().out.splitlines())
    results = str(tmp_path / "results")
    assert detect.main([root, "-o", results, "-r", "1", "--batch", "2",
                        "--score-threshold", "0.0", *dev]) == 0
    assert sorted(os.listdir(results)) == ["000004.txt", "000005.txt"]
