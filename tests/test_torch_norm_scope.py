"""PyTorch port: ``norm_scope="batch"`` against the JAX package.

Under ``norm_scope="batch"`` JAX's ``train/state.make_apply`` applies the
model to the whole batch, so every stateless norm takes batch-wide
statistics: K1's row statistics and the fusion MLP's virtual-row count
are batch totals too.  The port's ``build_model`` sets its norms'
``batch_stats`` (``models/blocks.set_norm_scope``) and runs the RPN
batched.

At B = 2 in float64 (JAX under ``jax.enable_x64``, compiled without XLA's
algebraic simplifier): the maps of ``MVXNetPM`` (column CML), of
``MVXNetVoxelFusion`` and of the LiDAR-only branch against JAX's
``make_apply(model, cfg)``, and one train step's loss, metrics and every
trainable gradient of ``MVXNetPM``, each to 1e-8 relative.  At B = 1 the
two scopes give the same maps bit for bit; at B = 2 they differ.  In
float32 and under ``use_bf16``, a batch-scope step with ``remat`` is bit
for bit the step without it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
from mvxnet_makise_tpu.models.mvxnet import (
    MVXNetVoxelFusion as JaxVoxelFusion,
)
from mvxnet_makise_tpu.models.voxelnet_pm import (
    VoxelNetBranchPM as JaxBranch,
)
from mvxnet_makise_tpu.train.loss import voxel_loss as jax_voxel_loss
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.step import _assign_batch as jax_assign_batch
from mvxnet_makise_tpu.train.step import _model_inputs
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.weights import (
    load_jax_params,
    mvxnet_state,
)
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    forward,
    frames_to_batch,
    make_train_step,
)
from _jax_ref import jit_dividing
from test_torch_fusion_modes import _random_params, _shapes
from test_torch_remat import _step, _tensors
from test_torch_train import _arrays, _frames, _rel
from test_torch_voxel_fusion import _random_params as _voxel_params

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0, batch_size=2)
TOL = 1e-8
MODELS = ("pm", "voxel", "lidar")


def _config(name, cls=Config, **kw):
    return cls(**KW, fusion_mode="voxel" if name == "voxel" else "pm", **kw)


def _port(name, params, **kw):
    """The port's model ``name`` with JAX's weights, in float64."""
    model = build_model(_config(name, **kw), seed=None, device="cpu",
                        with_images=name != "lidar")
    load_jax_params(model, params)
    return model.double()


def _port_maps(name, params, arrays, **kw):
    pts, nums, imgs = (torch.from_numpy(a) for a in arrays[:3])
    cfg = _config(name, **kw)
    with torch.no_grad():
        return forward(_port(name, params, **kw),
                       frames_to_batch(pts.double(), nums, imgs.double(),
                                       cfg), cfg, name != "lidar")


@pytest.fixture(scope="module")
def scope_run():
    """JAX's batch-scope maps of the three models and one MVXNetPM train
    step, all in float64, and the weights and frames behind them."""
    jcfg = {n: _config(n, JaxConfig, norm_scope="batch") for n in MODELS}
    kw = dict(grid_shape=KW["voxel_shape"], image_size=KW["image_size"],
              anchors_per_loc=2, image_min_side=0)
    models = dict(
        pm=JaxMVXNetPM(samples_per_voxel=KW["samples_per_voxel"],
                       cml_mode="column", **kw),
        voxel=JaxVoxelFusion(**kw),
        lidar=JaxBranch(KW["voxel_shape"], anchors_per_loc=2,
                        samples_per_voxel=KW["samples_per_voxel"],
                        cml_mode="column"))
    rng = np.random.default_rng(0)
    params = dict(pm=_random_params(_shapes("pm", models["pm"],
                                            jcfg["pm"]), rng),
                  voxel=_voxel_params(models["voxel"], jcfg["voxel"], rng),
                  lidar=_random_params(_shapes("pm_lidar", models["lidar"],
                                               jcfg["lidar"]), rng))
    arrays = tuple(t.numpy() for t in _collated())
    anchors = create_anchors(jcfg["pm"].feature_map_shape,
                             KW["velo_range"],
                             jcfg["pm"].anchor_sizes).astype(np.float64)
    key = jax.random.key(5)
    perm = np.stack([np.asarray(jax.random.permutation(k, KW["max_points"]))
                     for k in jax.random.split(key, 2)])
    applies = {n: make_apply(models[n], jcfg[n]) for n in MODELS}
    with jax.enable_x64(True):
        p64 = {n: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
               for n, p in params.items()}
        ext = p64["pm"]["params"]["head"]["extractor"]

        def loss_fn(rest, batch):
            targets = jax_assign_batch(batch, jcfg["pm"])
            head = dict(rest["head"], extractor=ext)
            score, reg = applies["pm"]({"params": dict(rest, head=head)},
                                       *_model_inputs(batch, True))
            c = jcfg["pm"]
            losses, metrics = jax.vmap(lambda s, r, t, g: jax_voxel_loss(
                s, r, t, g, jnp.asarray(anchors),
                pos_weight=c.pos_loss_weight, neg_weight=c.neg_loss_weight,
                eps=c.eps, mode=c.cls_loss_mode,
                focal_gamma=c.focal_gamma, focal_alpha=c.focal_alpha))(
                score, reg, targets, batch.gt_boxes)
            return jnp.mean(losses), jax.tree.map(jnp.mean, metrics)

        def run(p, pts, nums, imgs, gts, gms, gcs):
            gt = (jnp.zeros((2, 1, 7)), jnp.zeros((2, 1), bool))
            pm = jax_batch(pts, nums, imgs, *gt, jcfg["pm"])
            slot = jax_batch(pts, nums, imgs, *gt, jcfg["voxel"])
            maps = dict(
                pm=applies["pm"](p["pm"], *_model_inputs(pm, True)),
                voxel=applies["voxel"](p["voxel"], slot.voxels, slot.coords,
                                       slot.vmask, slot.images),
                lidar=applies["lidar"](p["lidar"],
                                       *_model_inputs(pm, False)))
            train = jax_batch(pts, nums, imgs, gts, gms, jcfg["pm"],
                              shuffle_key=key, gt_classes=gcs)
            rest = dict(p["pm"]["params"])
            rest["head"] = {k: v for k, v in rest["head"].items()
                            if k != "extractor"}
            step = jax.value_and_grad(loss_fn, has_aux=True)(rest, train)
            return maps, step

        maps, ((loss, metrics), grads) = jit_dividing(run)(
            p64, jnp.asarray(arrays[0], jnp.float64),
            jnp.asarray(arrays[1]), jnp.asarray(arrays[2], jnp.float64),
            jnp.asarray(arrays[3], jnp.float64), jnp.asarray(arrays[4]),
            jnp.asarray(arrays[5]))
        grads = jax.device_get(grads)
        grads["head"]["extractor"] = jax.device_get(ext)
        jax_out = dict(
            maps=jax.tree.map(np.asarray, maps), loss=float(loss),
            metrics={k: float(v) for k, v in metrics.items()},
            grads={k: v for k, v in mvxnet_state(grads).items()
                   if "extractor" not in k})
    return dict(jax=jax_out, params=params, arrays=arrays, perm=perm,
                anchors=anchors)


def _collated():
    from mvxnet_makise_tpu_torch.train.loop import collate

    cfg = Config(**KW)
    return collate(_arrays(cfg, _frames(cfg)), torch.device("cpu"))


@pytest.mark.parametrize("name", MODELS)
def test_batch_scope_maps_match_jax(scope_run, name):
    got = _port_maps(name, scope_run["params"][name], scope_run["arrays"],
                     norm_scope="batch")
    for g, w in zip(got, scope_run["jax"]["maps"][name]):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= TOL


def test_batch_scope_train_step_matches_jax(scope_run):
    """MVXNetPM under batch scope: loss, metrics and every trainable
    gradient to 1e-8."""
    cfg = _config("pm", norm_scope="batch")
    model = _port("pm", scope_run["params"]["pm"], norm_scope="batch")
    state = TrainState.create(cfg, model.train())
    a = [torch.from_numpy(x) for x in scope_run["arrays"]]
    batch = frames_to_batch(a[0].double(), a[1], a[2].double(), cfg,
                            gt_boxes=a[3].double(), gt_mask=a[4],
                            gt_classes=a[5],
                            perm=torch.from_numpy(scope_run["perm"]))
    got = make_train_step(cfg, torch.from_numpy(scope_run["anchors"]))(
        state, batch)
    want = scope_run["jax"]
    assert float(got["num_pos"]) > 0
    np.testing.assert_allclose(float(got["total_loss"]), want["loss"],
                               rtol=TOL)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=TOL, err_msg=k)
    checked = 0
    for name, p in model.named_parameters():
        if "extractor" in name:
            continue
        assert _rel(p.grad.numpy(), np.asarray(want["grads"][name])) \
            <= TOL, name
        checked += 1
    assert checked == len(want["grads"])


@pytest.mark.parametrize("name", MODELS)
def test_scopes_agree_on_one_frame_and_differ_on_two(scope_run, name):
    params, arrays = scope_run["params"][name], scope_run["arrays"]
    one = tuple(a[:1] for a in arrays)
    sample = _port_maps(name, params, one, norm_scope="sample")
    batch = _port_maps(name, params, one, norm_scope="batch")
    for s, b in zip(sample, batch):
        assert torch.equal(s, b)
    sample = _port_maps(name, params, arrays, norm_scope="sample")
    batch = _port_maps(name, params, arrays, norm_scope="batch")
    for s, b in zip(sample, batch):
        assert (s - b).abs().max() > 1e-3 * b.abs().max()


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_batch_scope_remat_is_bit_equal_to_no_remat(bf16):
    """The checkpointed CML recomputes with the batch-wide statistics."""
    cfg = Config(**KW, norm_scope="batch", use_bf16=bf16)
    weights = build_model(cfg, seed=3, device="cpu").state_dict()
    tensors, perm = _tensors(cfg)
    plain = _step(cfg, weights, tensors, perm)
    remat = _step(cfg.replace(remat=True), weights, tensors, perm)
    assert float(plain[0]["num_pos"]) > 0
    assert torch.isfinite(plain[0]["total_loss"])
    assert (plain[2], remat[2]) == (1, 2)
    for k in plain[0]:
        assert torch.equal(plain[0][k], remat[0][k]), k
    assert plain[1].keys() == remat[1].keys() and len(plain[1]) > 10
    for k, g in plain[1].items():
        assert torch.isfinite(g).all(), k
        assert torch.equal(g, remat[1][k]), k
