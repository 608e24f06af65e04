"""PyTorch port: the fusion and CML modes JAX's ``Config`` describes that
compute ``MVXNetPM``'s function, against the JAX modules that define them.

JAX's ``MVXNet`` (``fusion_mode="slot"``, the reference's dataflow over
the (V, T, C) slot tensor) and ``MVXNetPointFusion`` (``"point"``) have
``MVXNetPM``'s parameter tree and compute its function, with the dense-3D
CML; ``MiddleConvLayersBanded`` (``cml_mode="banded"``) is the dense CML's
conv1 in another layout; the LiDAR-only detector under a fusion mode
other than "pm" is JAX's slot-major ``VoxelNetBranch``.  The port's
``build_model`` builds them as ``MVXNetPM``, the column CML and
``VoxelNetBranchPM``, and ``load_jax_params`` takes their trees.

In float64 (JAX under ``jax.enable_x64``, compiled without XLA's
algebraic simplifier): the banded CML and the LiDAR-only branch to 1e-8
relative; "slot" and "point" to 1e-8, or to ``SLOT_FACTOR`` times JAX's
own ``MVXNet``-vs-``MVXNetPM`` distance on the same inputs where that is
larger.  Measured on a CPU (relative to the largest value, score and
reg): slot 2.5e-12 and 2.5e-12, point 2.5e-12 and 2.5e-12, banded
2.5e-12 and 2.5e-12, LiDAR-only 4.0e-13 and 4.3e-13; JAX's own
``MVXNet``-vs-``MVXNetPM`` distance 1.1e-12 and 1.2e-12.

Under ``use_bf16`` "slot" and "point" run the point-major function, whose
geometry stays float32, where JAX rounds the slot tensor (the image
projections included) to bfloat16: they are held by
``tests/test_torch_bf16.py``'s rule, the port's distance from JAX's
bfloat16 maps at most twice JAX's own bfloat16-to-float32 distance, with
the RPN trunk cut.  Measured on a CPU (port, JAX's own, largest value):
slot score 0.59, 0.61, 0.99 and reg 3.3, 3.3, 5.3; point score 0.58,
0.56 and reg 3.1, 3.9.  The untrained fused model is near chaos in
bfloat16 (``tests/test_torch_bf16.py``), so these distances are as large
as JAX's own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.models import MVXNet as JaxMVXNet
from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
from mvxnet_makise_tpu.models import MVXNetPointFusion as JaxPointFusion
from mvxnet_makise_tpu.models import VoxelNetBranch as JaxVoxelNetBranch
from mvxnet_makise_tpu.train.state import cast_for_compute as jax_cast
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.step import cast_batch_for_compute as jax_castb
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data import native
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models.blocks import DenseReluNormVirtual
from mvxnet_makise_tpu_torch.models.mvxnet import (
    MVXNetPM,
    MVXNetVoxelFusion,
    build_model,
)
from mvxnet_makise_tpu_torch.models.voxelnet import MiddleConvLayersColumn
from mvxnet_makise_tpu_torch.models.voxelnet_pm import VoxelNetBranchPM
from mvxnet_makise_tpu_torch.models.weights import load_jax_params
from mvxnet_makise_tpu_torch.train.step import forward, frames_to_batch
from _jax_ref import jit_dividing

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0, batch_size=2)
TOL = 1e-8
SLOT_FACTOR = 10.0
BF16_TRUNK = dict(rpn_channels=(32, 32, 64), rpn_extra=(0, 0, 0),
                  rpn_deconv_channels=32)
BF16_FACTOR = 2.0
MODES = ("slot", "point")


def _models(jcfg):
    """JAX's three fused models of one parameter tree, and its slot-major
    LiDAR branch."""
    kw = dict(grid_shape=jcfg.voxel_shape, image_size=jcfg.image_size,
              anchors_per_loc=jcfg.anchors_per_loc,
              image_min_side=jcfg.image_min_side, rpn_trunk=jcfg.rpn_trunk)
    return dict(
        slot=JaxMVXNet(**kw), point=JaxPointFusion(**kw),
        pm=JaxMVXNetPM(samples_per_voxel=jcfg.samples_per_voxel,
                       cml_mode="column", **kw),
        banded=JaxMVXNetPM(samples_per_voxel=jcfg.samples_per_voxel,
                           cml_mode="banded", **kw),
        lidar=JaxVoxelNetBranch(grid_shape=jcfg.voxel_shape,
                                anchors_per_loc=jcfg.anchors_per_loc,
                                cml_mode="column",
                                rpn_trunk=jcfg.rpn_trunk))


def _shapes(name, model, jcfg):
    """The parameter shapes of JAX's model ``name`` ("slot", "point",
    "lidar", "pm_lidar" for the point-major LiDAR branch, else a
    point-major fused model)."""
    P, V, T = jcfg.max_points, jcfg.max_voxels, jcfg.samples_per_voxel
    coords, mask = jnp.zeros((1, V, 3), jnp.int32), jnp.zeros((1, V), bool)
    img = jnp.zeros((1, *jcfg.image_size, 3))
    sorted_ = (jnp.zeros((1, P), bool), jnp.full((1, P), V, jnp.int32),
               jnp.zeros((1, V), jnp.int32), coords, mask)
    args = {
        "slot": (jnp.zeros((1, V, T, 9)), coords, mask, img),
        "point": (jnp.zeros((1, V, T, 9)), coords, mask, img,
                  jnp.zeros((1, P, 6)), jnp.full((1, P), -1, jnp.int32)),
        "lidar": (jnp.zeros((1, V, T, 7)), coords, mask),
        "pm_lidar": (jnp.zeros((1, P, 7)), *sorted_)}.get(
        name, (jnp.zeros((1, P, 6)), *sorted_, img))
    return jax.eval_shape(model.init, jax.random.key(0), *args)


def _random_params(shapes, rng):
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


def _inputs(cfg, rng):
    frames = [synthetic_frame(rng, cfg, num_cars=2, num_points=n)[:3]
              for n in (900, 1500)]
    return native.assemble_batch(frames, cfg.velo_range, cfg.image_size,
                                 cfg.max_points, 2)


def _apply_all(models, jcfg, cast: bool):
    """A function of (params, LiDAR-only params, arrays) running each of
    ``models`` on the batch JAX's voxelizer gives it, with ``cast``
    under ``use_bf16``'s casts."""
    applies = {k: make_apply(m, jcfg) for k, m in models.items()}

    def run(p, lp, pts, nums, imgs):
        gt = (jnp.zeros((2, 1, 7)), jnp.zeros((2, 1), bool))
        slot = jax_batch(pts, nums, imgs, *gt, jcfg, point_major=False)
        pm = jax_batch(pts, nums, imgs, *gt, jcfg, point_major=True)
        if cast:
            p, lp = jax_cast(p, True), jax_cast(lp, True)
            slot, pm = jax_castb(slot, True), jax_castb(pm, True)
        pm_args = (pm.sorted_points, pm.sorted_kept, pm.sorted_seg,
                   pm.counts, pm.coords, pm.vmask, pm.images)
        slot_args = (slot.voxels, slot.coords, slot.vmask, slot.images)
        out = {"slot": applies["slot"](p, *slot_args),
               "point": applies["point"](p, *slot_args, slot.points,
                                         slot.point_slots)}
        for name in ("pm", "banded"):
            if name in applies:
                out[name] = applies[name](p, *pm_args)
        if "lidar" in applies:
            out["lidar"] = applies["lidar"](lp, slot.voxels[..., :7],
                                            slot.coords, slot.vmask)
        return out
    return run


def _port_maps(cfg, params, arrays, with_images=True, dtype=None):
    port = build_model(cfg, seed=None, device="cpu",
                       with_images=with_images)
    load_jax_params(port, params)
    if dtype is not None:
        port = port.to(dtype)
    pts, nums, imgs = (torch.from_numpy(a) for a in arrays)
    if dtype is not None:
        pts, imgs = pts.to(dtype), imgs.to(dtype)
    with torch.no_grad():
        return port, forward(port, frames_to_batch(pts, nums, imgs, cfg),
                             cfg, with_images)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module")
def modes_run():
    """Every JAX model's float64 maps on one weight set, and the port's
    for each mode."""
    jcfg = JaxConfig(**KW)
    models = _models(jcfg)
    shapes = {k: _shapes(k, m, jcfg) for k, m in models.items()}
    rng = np.random.default_rng(0)
    params = _random_params(shapes["pm"], rng)
    lidar_params = _random_params(shapes["lidar"], rng)
    arrays = _inputs(Config(**KW), rng)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        args = (f64(params), f64(lidar_params))
        compiled = jit_dividing(_apply_all(models, jcfg, cast=False))
        jax_maps = jax.tree.map(np.asarray,
                                compiled(*args, *_jax_arrays(arrays)))
    port = {}
    for mode in MODES:
        port[mode] = _port_maps(Config(**KW, fusion_mode=mode), params,
                                arrays, dtype=torch.float64)
    port["banded"] = _port_maps(Config(**KW, cml_mode="banded"), params,
                                arrays, dtype=torch.float64)
    port["lidar"] = _port_maps(Config(**KW, fusion_mode="slot"),
                               lidar_params, arrays, with_images=False,
                               dtype=torch.float64)
    def run_jax(other):
        """JAX's maps of every model on other arrays of these shapes."""
        with jax.enable_x64(True):
            return jax.tree.map(np.asarray,
                                compiled(*args, *_jax_arrays(other)))
    return dict(jax=jax_maps, port=port, shapes=shapes, params=params,
                lidar_params=lidar_params, arrays=arrays, run_jax=run_jax)


def _jax_arrays(arrays):
    """An assembled batch as JAX's float64 inputs (call under x64)."""
    return (jnp.asarray(arrays[0], jnp.float64), jnp.asarray(arrays[1]),
            jnp.asarray(arrays[2], jnp.float64))


def test_each_mode_builds_its_function(modes_run):
    """"slot" and "point" build MVXNetPM, "banded" the column CML, the
    LiDAR-only model under "slot" the point-major branch; their JAX trees
    share one structure."""
    shapes = modes_run["shapes"]
    tree = jax.tree_util.tree_structure
    for mode in MODES:
        assert tree(shapes[mode]) == tree(shapes["pm"]), mode
        model, _ = modes_run["port"][mode]
        assert type(model) is MVXNetPM, mode
        assert isinstance(model.head.fusion.fcn1, DenseReluNormVirtual)
    banded, _ = modes_run["port"]["banded"]
    assert isinstance(banded.backbone.cml, MiddleConvLayersColumn)
    lidar, _ = modes_run["port"]["lidar"]
    assert type(lidar) is VoxelNetBranchPM


@pytest.mark.parametrize("mode", MODES)
def test_fusion_mode_maps_match_jax(modes_run, mode):
    """The port's maps against JAX's own module of the mode, to 1e-8 or
    SLOT_FACTOR times JAX's own slot-vs-point-major distance."""
    want = modes_run["jax"][mode]
    _, got = modes_run["port"][mode]
    for i, what in enumerate(("score", "reg")):
        jax_own = _rel(modes_run["jax"]["pm"][i], modes_run["jax"]["slot"][i])
        assert _rel(got[i].numpy(), want[i]) <= max(
            TOL, SLOT_FACTOR * jax_own), what


def test_banded_cml_matches_jax(modes_run):
    _, got = modes_run["port"]["banded"]
    for g, w in zip(got, modes_run["jax"]["banded"]):
        assert _rel(g.numpy(), w) <= TOL


def test_lidar_only_slot_mode_matches_jax_voxelnet_branch(modes_run):
    """JAX builds the slot-major VoxelNetBranch for the LiDAR-only model
    of a fusion mode other than "pm"; the port's point-major branch
    computes it."""
    _, got = modes_run["port"]["lidar"]
    assert got[0].shape == (2, 16, 20, 2)
    for g, w in zip(got, modes_run["jax"]["lidar"]):
        assert _rel(g.numpy(), w) <= TOL


@pytest.fixture(scope="module")
def bf16_run(modes_run):
    kw = dict(KW, **BF16_TRUNK, use_bf16=True)
    jcfg = JaxConfig(**kw)
    models = {k: m for k, m in _models(jcfg).items() if k in MODES}
    params = _random_params(_shapes("slot", models["slot"], jcfg),
                            np.random.default_rng(4))
    lp = {}
    arrays = modes_run["arrays"]
    jarr = [jnp.asarray(a) for a in arrays]

    def both(p, lp, pts, nums, imgs):
        return (_apply_all(models, jcfg, cast=True)(p, lp, pts, nums, imgs),
                _apply_all(models, jcfg, cast=False)(p, lp, pts, nums,
                                                     imgs))
    bf16, f32 = jit_dividing(both)(params, lp, *jarr)
    port = {mode: _port_maps(Config(**kw, fusion_mode=mode), params,
                             arrays)[1] for mode in MODES}
    return dict(bf16=bf16, f32=f32, port=port)


@pytest.mark.parametrize("mode", MODES)
def test_fusion_mode_bf16_maps_match_jax(bf16_run, mode):
    def f64(a):
        if torch.is_tensor(a):
            return a.double().numpy()
        return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)
    for i, what in enumerate(("score", "reg")):
        got = bf16_run["port"][mode][i]
        assert got.dtype == torch.bfloat16
        want, f32 = bf16_run["bf16"][mode][i], bf16_run["f32"][mode][i]
        d_port = float(np.abs(f64(got) - f64(want)).max())
        d_jax = float(np.abs(f64(want) - f64(f32)).max())
        assert 0 < d_jax and d_port <= BF16_FACTOR * d_jax, (
            what, d_port, d_jax)


def test_load_jax_params_takes_each_tree(modes_run):
    """Each tree into the model its mode builds; a tree of another model
    is refused."""
    cfg = Config(**KW, fusion_mode="slot")
    model = build_model(cfg, seed=None, device="cpu")
    load_jax_params(model, modes_run["params"])
    w = modes_run["params"]["params"]["head"]["fusion"]["fcn1"]["fc"]
    np.testing.assert_array_equal(
        model.head.fusion.fcn1.fc.weight.detach().numpy(),
        np.asarray(w["kernel"]).T)
    lidar = build_model(cfg, seed=None, device="cpu", with_images=False)
    load_jax_params(lidar, modes_run["lidar_params"])
    voxel = build_model(Config(**KW, fusion_mode="voxel"), seed=None,
                        device="cpu")
    assert isinstance(voxel, MVXNetVoxelFusion)
    with pytest.raises(KeyError):
        load_jax_params(voxel, modes_run["params"])
    with pytest.raises(KeyError):
        load_jax_params(lidar, modes_run["params"])


@pytest.mark.parametrize("field,value", [("fusion_mode", "slots"),
                                         ("cml_mode", "sparse")])
def test_build_model_refuses_unknown_modes(field, value):
    with pytest.raises(ValueError, match=value):
        build_model(Config(**KW, **{field: value}), seed=None, device="cpu",
                    with_images=False)


def _with_origin_point(arrays):
    """The batch with a real point at x = y = z = 0 in each frame
    (reflectance 0.5, inside the image), after the frame's last point or
    in place of it when the frame is full."""
    pts, nums, imgs = (np.array(a) for a in arrays)
    for b in range(len(nums)):
        i = min(int(nums[b]), pts.shape[1] - 1)
        pts[b, i] = (0.0, 0.0, 0.0, 0.5, 30.0, 40.0)
        nums[b] = max(int(nums[b]), i + 1)
    return pts, nums, imgs


@pytest.fixture(scope="module")
def origin_run(modes_run):
    """JAX's "slot", "point" and "pm" models and the port's, float64, on
    frames that hold a real point at the LiDAR origin."""
    params = modes_run["params"]
    arrays = _with_origin_point(modes_run["arrays"])
    jax_maps = modes_run["run_jax"](arrays)
    port = {mode: _port_maps(Config(**KW, fusion_mode=mode), params, arrays,
                             dtype=torch.float64)[1]
            for mode in ("slot", "point", "pm")}
    return dict(jax=jax_maps, port=port, arrays=arrays)


@pytest.mark.parametrize("mode", ["slot", "point", "pm"])
def test_origin_point_follows_each_jax_model(origin_run, modes_run, mode):
    """JAX's ``MVXNet`` ("slot") takes a sample at x = y = z = 0 for an
    empty slot of the image branch; ``MVXNetPointFusion`` ("point") and
    ``MVXNetPM`` ("pm") gather its image feature.  The port's maps equal
    each JAX model's on frames holding such a point (the tolerance of
    :func:`test_fusion_mode_maps_match_jax`), and "slot" differs from
    "pm" there."""
    got = origin_run["port"][mode]
    for i in range(2):
        jax_own = _rel(modes_run["jax"]["pm"][i], modes_run["jax"]["slot"][i])
        assert _rel(got[i].numpy(), origin_run["jax"][mode][i]) <= max(
            TOL, SLOT_FACTOR * jax_own)
    slot, pm = origin_run["port"]["slot"], origin_run["port"]["pm"]
    assert _rel(slot[0].numpy(), pm[0].numpy()) > 1e-6
    # the point was kept: it lies in the crop range, and the frames
    # have room
    pts, nums, _ = origin_run["arrays"]
    assert all((pts[b, :nums[b], :3] == 0).all(axis=1).sum() == 1
               for b in range(len(nums)))
