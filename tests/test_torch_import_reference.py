"""PyTorch port: weights to and from the reference PyTorch MVXNet
(``models/import_reference.py``) against the JAX package's importer.

A reference-layout state dict comes from JAX's
``export_reference_checkpoint`` of a random JAX parameter tree (full layer
widths, a tiny grid; every kernel, bias and folded norm random).  The
port's import of it must equal, bit for bit, the JAX import loaded into
the port's model (``models/weights.load_jax_params``), fused and
LiDAR-only; the port's export of a model holding JAX's parameters must
equal JAX's export key for key and bit for bit; the round trip is exact;
an exported folded norm computes what ``torch.nn.BatchNorm2d`` does in
eval mode; and the imported model's maps equal JAX's model on JAX's
import in float64, within 1e-8 of the largest value.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
from mvxnet_makise_tpu.models import VoxelNetBranchPM as JaxBranchPM
from mvxnet_makise_tpu.models.import_reference import (
    export_reference_checkpoint as jax_export,
)
from mvxnet_makise_tpu.models.import_reference import (
    import_reference_checkpoint as jax_import,
)
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.step import _model_inputs
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.native import assemble_batch
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models.import_reference import (
    export_reference_checkpoint,
    import_reference_checkpoint,
)
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.resnet_fpn import FoldedNorm
from mvxnet_makise_tpu_torch.models.weights import load_jax_params
from mvxnet_makise_tpu_torch.tools import export_checkpoint
from mvxnet_makise_tpu_torch.train.checkpoint import save_checkpoint
from mvxnet_makise_tpu_torch.train.step import (
    frames_to_batch,
    lidar_inputs,
    model_inputs,
)

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0)
CFG = Config(**KW)
JCFG = JaxConfig(**KW)


def _jax_model(with_images):
    if with_images:
        return JaxMVXNetPM(
            grid_shape=JCFG.voxel_shape, image_size=JCFG.image_size,
            anchors_per_loc=JCFG.anchors_per_loc,
            image_min_side=JCFG.image_min_side,
            samples_per_voxel=JCFG.samples_per_voxel,
            cml_mode=JCFG.cml_mode)
    return JaxBranchPM(grid_shape=JCFG.voxel_shape,
                       anchors_per_loc=JCFG.anchors_per_loc,
                       samples_per_voxel=JCFG.samples_per_voxel,
                       cml_mode=JCFG.cml_mode)


def _random_params(with_images, seed):
    """A random JAX parameter tree (numpy float32 leaves) of the fused or
    the LiDAR-only model: kernels normal(0, 1/fan_in), biases normal,
    folded-norm scales uniform(0.5, 1.5)."""
    P, V = JCFG.max_points, JCFG.max_voxels
    args = [jnp.zeros((1, P, 6 if with_images else 7)),
            jnp.zeros((1, P), bool), jnp.full((1, P), V, jnp.int32),
            jnp.zeros((1, V), jnp.int32), jnp.zeros((1, V, 3), jnp.int32),
            jnp.zeros((1, V), bool)]
    if with_images:
        args.append(jnp.zeros((1, *JCFG.image_size, 3)))
    shapes = jax.eval_shape(_jax_model(with_images).init,
                            jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

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


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused", "lidar_only"])
def weights(request):
    """(with_images, JAX params, JAX's reference-layout export of them)."""
    with_images = request.param
    params = _random_params(with_images, seed=int(with_images))
    return with_images, params, jax_export(params, with_images=with_images)


def _port_model(with_images, params=None):
    model = build_model(CFG, seed=0, device="cpu", with_images=with_images)
    if params is not None:
        load_jax_params(model, params)
    return model


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = torch.as_tensor(got[k]), torch.as_tensor(np.asarray(want[k]))
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def test_import_equals_jax_import(weights):
    with_images, _, ref = weights
    got = import_reference_checkpoint(
        {k: torch.from_numpy(np.array(v)) for k, v in ref.items()},
        with_images=with_images)
    want = _port_model(with_images, jax_import(ref, with_images=with_images))
    _assert_same_state(got, want.state_dict())
    # numpy values import the same, and load strictly
    _assert_same_state(import_reference_checkpoint(ref, with_images), got)
    _port_model(with_images).load_state_dict(got, strict=True)


def test_export_equals_jax_export(weights):
    with_images, params, ref = weights
    got = export_reference_checkpoint(
        _port_model(with_images, params).state_dict(), with_images)
    _assert_same_state(got, ref)


def test_round_trip_is_exact(weights):
    """A port model with random folded norms goes out and back bit for
    bit (running_var = 1 - eps makes the fold divide by exactly 1)."""
    with_images, params, _ = weights
    sd = _port_model(with_images, params).state_dict()
    back = import_reference_checkpoint(
        export_reference_checkpoint(sd, with_images), with_images)
    _assert_same_state(back, sd)


@pytest.mark.parametrize("flags", [[], ["--lidar-only"]],
                         ids=["no_flag", "lidar_only_flag"])
def test_export_checkpoint_tool_equals_jax_export(weights, flags, tmp_path,
                                                  capsys):
    """``tools.export_checkpoint`` on a saved port checkpoint writes JAX's
    export of the same parameters; the detector kind comes from the
    checkpoint, whatever ``--lidar-only`` says."""
    with_images, params, ref = weights
    model = _port_model(with_images, params)
    save_checkpoint(str(tmp_path), 1, SimpleNamespace(
        model=model, optimizer=torch.optim.AdamW(model.parameters()),
        step=0))
    out = str(tmp_path / "ref.pkl")
    assert export_checkpoint.main(
        ["-r", "1", "-o", out, "--checkpoint-dir", str(tmp_path), *flags]) == 0
    assert ("fused" if with_images else "LiDAR-only") in capsys.readouterr().out
    _assert_same_state(torch.load(out, weights_only=True), ref)


def test_exported_folded_norm_is_batchnorm_in_eval_mode():
    rng = np.random.default_rng(3)
    norm = FoldedNorm(64)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(
            rng.uniform(0.5, 1.5, 64).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(
            rng.normal(0, 0.1, 64).astype(np.float32)))
    ref = export_reference_checkpoint(
        {"head.extractor.backbone.body.bn1." + k: v
         for k, v in norm.state_dict().items()})
    bn = torch.nn.BatchNorm2d(64).eval()
    bn.load_state_dict({k.removeprefix("head.extractor.backbone.body.bn1."):
                        v for k, v in ref.items()}, strict=True)
    x = torch.from_numpy(rng.normal(0, 2, (2, 64, 5, 7)).astype(np.float32))
    with torch.no_grad():
        want, got = bn(x), norm(x)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def _frames_arrays():
    rng = np.random.default_rng(5)
    frames = [synthetic_frame(rng, CFG, num_cars=2, num_points=n)[:3]
              for n in (900, 1500)]
    return assemble_batch(frames, CFG.velo_range, CFG.image_size,
                          CFG.max_points, len(frames))


def _run_dividing(fn, *args):
    """``fn(*args)`` compiled without XLA's algebraic simplifier (it turns
    divisions by constants into multiplications one ulp apart)."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return compiled(*args)


@torch.no_grad()
def test_imported_maps_match_jax_in_float64(weights):
    with_images, _, ref = weights
    model = _port_model(with_images).double()
    model.load_state_dict(import_reference_checkpoint(ref, with_images))
    pts, nums, imgs = _frames_arrays()
    b = frames_to_batch(torch.from_numpy(pts).double(),
                        torch.from_numpy(nums),
                        torch.from_numpy(imgs).double(), CFG)
    inputs = (model_inputs(b) if with_images
              else lidar_inputs(b, CFG.samples_per_voxel))
    got = model(*inputs)

    jparams = jax_import(ref, with_images=with_images)
    with jax.enable_x64(True):
        jb = _run_dividing(lambda p, n, i: jax_batch(
            p, n, i, jnp.zeros((2, 1, 7)), jnp.zeros((2, 1), bool), JCFG),
            jnp.asarray(pts, jnp.float64), jnp.asarray(nums),
            jnp.asarray(imgs, jnp.float64))
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
        want = _run_dividing(make_apply(_jax_model(with_images), JCFG), p64,
                             *_model_inputs(jb, with_images))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(w).max()))
