"""PyTorch port: bfloat16 compute (``use_bf16``) against the JAX package.

The same weights (``models/weights.load_jax_params``) and the same inputs
go through JAX's bfloat16 run (its ``cast_for_compute`` of the parameters
and ``cast_batch_for_compute`` of the batch), JAX's float32 run, and the
port's bfloat16 run (``train/state.cast_for_compute``).  bfloat16 keeps 8
bits of mantissa and the untrained model's stateless norms amplify
rounding, so no fixed epsilon fits: the port's distance from JAX's
bfloat16 result (max abs, in float64) must be at most ``FACTOR`` times
JAX's own bfloat16-to-float32 distance on the same inputs.  The config is
the tiny one with the RPN trunk cut to one convolution per stage (32, 32,
64 wide): with the reference trunk the untrained LiDAR branch is chaotic
in bfloat16 (its maps as far from JAX's bfloat16 maps as those are from
float32), and a cut trunk keeps it out of that regime.

Measured on a CPU (port distance, JAX's distance, largest value):
the four norms and K2's plain version against JAX's default gather are
bit-equal to JAX (0, and asserted so); K2's plain version against the Pallas kernel 0.25,
0.15, 26; column conv1 0.25, 0.19, 29; the image head's features 7.3,
13.2, 33 (the frozen ResNet50-FPN's bfloat16 convolutions round apart,
and five stateless norms amplify it) and its empty-slot row 0.025, 0.015,
0.44; the LiDAR branch score 0.031, 0.041, 1.0 and reg 0.20, 0.24, 6.7;
the whole model score 0.48, 0.42, 1.0 and reg 3.3, 3.3, 6.7 (chaotic: the
image head feeds it); one train step's loss 0.0074, 0.16 (of 2.6) and
every master gradient's norm distance at most 1.23 times JAX's.

Output dtypes follow JAX's promotion: bfloat16 maps for the fused model,
float32 for the LiDAR-only branch (its point features stay float32; its
values under ``use_bf16`` are held to JAX's in
``tests/test_torch_lidar_only.py``).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
from mvxnet_makise_tpu.models import blocks as jb
from mvxnet_makise_tpu.models import image_head as jax_head
from mvxnet_makise_tpu.models.voxelnet import (
    ColumnConv1ReluNorm as JaxConv1,
)
from mvxnet_makise_tpu.models.voxelnet_pm import (
    VoxelNetBranchPM as JaxBranch,
)
from mvxnet_makise_tpu.ops.gather import bilinear_gather_fpn_batch
from mvxnet_makise_tpu.ops.pallas_gather import fpn_gather_banded
from mvxnet_makise_tpu.train.state import cast_for_compute as jax_cast
from mvxnet_makise_tpu.train.state import make_apply
from mvxnet_makise_tpu.train.step import _assign_batch as jax_assign_batch
from mvxnet_makise_tpu.train.step import _model_inputs
from mvxnet_makise_tpu.train.step import cast_batch_for_compute as jax_castb
from mvxnet_makise_tpu.train.step import compute_loss as jax_compute_loss
from mvxnet_makise_tpu.train.step import frames_to_batch as jax_batch
from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data import native
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models import blocks as tb
from mvxnet_makise_tpu_torch.models.image_head import gather_image_size
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.weights import (
    load_jax_params,
    mvxnet_state,
)
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.ops.gather import fpn_gather_plain
from mvxnet_makise_tpu_torch.train.state import TrainState, cast_for_compute
from mvxnet_makise_tpu_torch.train.step import (
    forward,
    frames_to_batch,
    make_train_step,
)

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0, batch_size=2,
          rpn_channels=(32, 32, 64), rpn_extra=(0, 0, 0),
          rpn_deconv_channels=32)
CFG = Config(**KW, use_bf16=True)
BF = jnp.bfloat16
FACTOR = 2.0


def _f64(a):
    if torch.is_tensor(a):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _dist(a, b) -> float:
    return float(np.abs(_f64(a) - _f64(b)).max())


def _held(port, jax_bf16, jax_f32, what):
    """The port's distance from JAX's bfloat16 result within FACTOR times
    JAX's bfloat16-to-float32 distance; returns both."""
    d_port, d_jax = _dist(port, jax_bf16), _dist(jax_bf16, jax_f32)
    assert d_jax > 0, what
    assert d_port <= FACTOR * d_jax, f"{what}: {d_port} > {FACTOR} * {d_jax}"
    return d_port, d_jax


def _exact(port, jax_bf16, jax_f32, what):
    """The port's result bit-equal to JAX's bfloat16 one, which differs
    from JAX's float32 one."""
    assert _dist(jax_bf16, jax_f32) > 0, what
    assert _dist(port, jax_bf16) == 0, what


def _bf16(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, BF), tree)


def _per_sample(fn, *xs):
    """``fn`` on batch-1 slices, results stacked (tuples element-wise)."""
    outs = [fn(*[x[i:i + 1] for x in xs]) for i in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(jnp.concatenate([jnp.reshape(o[k], (1, -1) if
                                                  o[k].ndim == 1 else
                                                  o[k].shape)
                                      for o in outs])
                     for k in range(len(outs[0])))
    return jnp.concatenate(outs)


def _random_params(model, rng):
    P, V = CFG.max_points, CFG.max_voxels
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, P, 6)),
        jnp.zeros((1, P), bool), jnp.full((1, P), V, jnp.int32),
        jnp.zeros((1, V), jnp.int32), jnp.zeros((1, V, 3), jnp.int32),
        jnp.zeros((1, V), bool), jnp.zeros((1, *CFG.image_size, 3)))

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
def run():
    """Weights, two voxelized frames on both sides, and the float32
    intermediates the per-module tests feed both sides."""
    jcfg = JaxConfig(**KW, use_bf16=True)
    rng = np.random.default_rng(0)
    model = JaxMVXNetPM(
        grid_shape=jcfg.voxel_shape, image_size=jcfg.image_size,
        anchors_per_loc=jcfg.anchors_per_loc,
        image_min_side=jcfg.image_min_side,
        samples_per_voxel=jcfg.samples_per_voxel, cml_mode="column",
        rpn_trunk=jcfg.rpn_trunk)
    params = _random_params(model, rng)
    frames = [synthetic_frame(rng, CFG, num_cars=2, num_points=n)[:3]
              for n in (900, 1500)]
    pts, nums, imgs = native.assemble_batch(
        frames, CFG.velo_range, CFG.image_size, CFG.max_points, 2)
    port = build_model(CFG, seed=None, device="cpu")
    load_jax_params(port, params)
    port.eval()
    tbatch = frames_to_batch(torch.from_numpy(pts), torch.from_numpy(nums),
                             torch.from_numpy(imgs), CFG)
    jbatch = jax.jit(lambda p, n, i: jax_batch(
        p, n, i, jnp.zeros((2, 1, 7)), jnp.zeros((2, 1), bool), jcfg))(
        jnp.asarray(pts), jnp.asarray(nums), jnp.asarray(imgs))
    b = tbatch
    with torch.no_grad():
        x, z0 = port.fused_inputs(b.sorted_points, b.sorted_kept,
                                  b.sorted_seg, b.counts, b.vmask,
                                  b.images)
        vfeat = port.backbone.voxel_features(x, b.sorted_kept, b.sorted_seg,
                                             b.counts, b.vmask, z0)
        pyramid = port.head.pyramid(b.images)
    n_virtual = (b.vmask.sum(1) * CFG.samples_per_voxel
                 - b.sorted_kept.sum(1))
    return dict(jcfg=jcfg, model=model, params=params, port=port,
                tbatch=tbatch, jbatch=jbatch, x=x, z0=z0, vfeat=vfeat,
                pyramid=pyramid, n_virtual=n_virtual)


# ------------------------------------------------------------- blocks


@pytest.mark.parametrize("block", ["standardize", "masked_standardize",
                                   "virtual", "virtual_weighted"])
@torch.no_grad()
def test_stateless_norms_in_bfloat16(block):
    """Sums and means accumulate in float32 and round to bfloat16, row
    counts included (24k rows would round to a multiple of 128);
    everything JAX holds in bfloat16 is bfloat16 here: bit-equal to
    JAX."""
    rng = np.random.default_rng(3)
    B = 2
    if block in ("standardize", "masked_standardize"):
        x = (rng.normal(size=(B, 50, 70, 4)) * 3 + 1).astype(np.float32)
        m = rng.random((B, 50, 70)) < 0.6

        def jfn(a, dt):
            if block == "standardize":
                return _per_sample(lambda s: jb.standardize(
                    jnp.asarray(s, dt)), a)
            return _per_sample(lambda s, mm: jb.masked_standardize(
                jnp.asarray(s, dt), jnp.asarray(mm)), a, m)
        want_b, want_f = jfn(x, BF), jfn(x, jnp.float32)
        xt = torch.from_numpy(x).bfloat16()
        got = (tb.standardize(xt, dims=(1, 2)) if block == "standardize"
               else tb.masked_standardize(xt, torch.from_numpy(m)))
        assert got.dtype == torch.bfloat16
        _exact(got, want_b, want_f, block)
        return
    P, V, C = 400, 30, 8
    x = rng.normal(size=(B, P, C)).astype(np.float32)
    m = rng.random((B, P)) < 0.7
    if block == "virtual":
        z = rng.normal(size=(B, C)).astype(np.float32)
        nv = np.array([1300, 7], np.int32)
        mod = jb.DenseReluNormVirtual(6)
        params = mod.init(jax.random.key(1), jnp.asarray(x[:1]),
                          jnp.asarray(m[:1]), jnp.asarray(z[0]),
                          jnp.asarray(nv[0]))
        t = tb.DenseReluNormVirtual(C, 6)

        def jfn(p, dt):
            return _per_sample(lambda a, mm, zz, n: mod.apply(
                p, jnp.asarray(a, dt), jnp.asarray(mm),
                jnp.asarray(zz[0], dt), jnp.asarray(n[0])), x, m, z, nv)
        targs = (torch.from_numpy(z).bfloat16(), torch.from_numpy(nv))
    else:
        z = rng.normal(size=(B, V, C)).astype(np.float32)
        w = rng.integers(0, 9, (B, V)).astype(np.float32)
        zm = rng.random((B, V)) < 0.8
        mod = jb.DenseReluNormVirtualWeighted(6)
        params = mod.init(jax.random.key(2), jnp.asarray(x[:1]),
                          jnp.asarray(m[:1]), jnp.asarray(z[:1]),
                          jnp.asarray(w[:1]), jnp.asarray(zm[:1]))
        t = tb.DenseReluNormVirtualWeighted(C, 6)

        def jfn(p, dt):
            return _per_sample(lambda a, mm, zz, ww, zmm: mod.apply(
                p, jnp.asarray(a, dt), jnp.asarray(mm), jnp.asarray(zz, dt),
                jnp.asarray(ww, dt), jnp.asarray(zmm)), x, m, z, w, zm)
        targs = (torch.from_numpy(z).bfloat16(),
                 torch.from_numpy(w).bfloat16(), torch.from_numpy(zm))
    want_b, want_f = jfn(_bf16(params), BF), jfn(params, jnp.float32)
    fc = params["params"]["fc"]
    t.fc.weight.copy_(torch.tensor(np.asarray(fc["kernel"]).T))
    t.fc.bias.copy_(torch.tensor(np.asarray(fc["bias"])))
    got = t.bfloat16()(torch.from_numpy(x).bfloat16(), torch.from_numpy(m),
                       *targs)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    _exact(got[0], want_b[0], want_f[0], block + " rows")
    _exact(got[1].reshape(want_b[1].shape), want_b[1], want_f[1],
           block + " virtual row")


# ------------------------------------------------------------- image


def test_fpn_gather_plain_in_bfloat16(run):
    """K2's plain version on a bfloat16 pyramid against JAX's default
    gather (raw4f), bit-equal, and the Pallas kernel in interpret mode
    (which sums in float32): bfloat16 out, offsets rounded to bfloat16."""
    levels = [p.bfloat16() for p in run["pyramid"]]
    b = run["tbatch"]
    rc = b.sorted_points[..., 4:6].contiguous()
    valid = b.sorted_kept
    gsize = gather_image_size(CFG.image_size, CFG.image_min_side)
    got = fpn_gather_plain(levels, rc, valid, gsize)
    assert got.dtype == torch.bfloat16
    jl = [jnp.asarray(p.float().numpy(), BF) for p in levels]
    jl32 = [jnp.asarray(p.numpy()) for p in run["pyramid"]]
    jrc, jok = jnp.asarray(rc.numpy()), jnp.asarray(valid.numpy())
    raw4f = jax.jit(lambda f: bilinear_gather_fpn_batch(
        tuple(f), jrc, jok, gsize, eps=1e-6, fuse_coarse=True))
    want_b, want_f = raw4f(jl), raw4f(jl32)
    assert want_b.dtype == BF
    _exact(got, want_b, want_f, "K2 plain vs raw4f")
    banded, pos, _ = fpn_gather_banded(jl, jrc, jok, gsize, interpret=True)
    pallas = jnp.take_along_axis(banded, pos[..., None], axis=1)
    _held(got, pallas, want_f, "K2 plain vs the Pallas kernel")


def test_fpn_gather_float32_sum_in_bfloat16(run):
    """``fpn_gather_plain(accumulate=float32)``, the bfloat16 kernel's
    formula (bfloat16 taps and offsets, float32 weights and sum, one
    rounding): within one bfloat16 step of the same formula summed in
    float64 (plus 2^-20 of the largest level value for float32 summation
    order), and apart from the default plain version, which rounds each
    product and sum as JAX's gather does."""
    levels = [p.bfloat16() for p in run["pyramid"]]
    b = run["tbatch"]
    args = (levels, b.sorted_points[..., 4:6].contiguous(), b.sorted_kept,
            gather_image_size(CFG.image_size, CFG.image_min_side))
    got = fpn_gather_plain(*args, accumulate=torch.float32)
    want = fpn_gather_plain(*args, accumulate=torch.float64)
    assert got.dtype == want.dtype == torch.bfloat16
    scale = max(float(p.float().abs().max()) for p in levels)
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    steps = ((g - w).abs() - scale * 2 ** -20).clamp(min=0) / torch.ldexp(
        torch.ones_like(g), e - 8)
    assert float(steps.max()) <= 1
    assert not torch.equal(got, fpn_gather_plain(*args))


def test_point_image_head_in_bfloat16(run):
    """Pyramid, gather and fusion MLP in bfloat16: per-point features and
    the empty-slot row."""
    port, b = run["port"], run["tbatch"]
    rc = b.sorted_points[..., 4:6].contiguous()
    with torch.no_grad():
        got = torch.func.functional_call(
            port.head, cast_for_compute(port.head, True),
            (b.images.bfloat16(), rc, b.sorted_kept, run["n_virtual"]))
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    jm = jax_head.PointImageHead(CFG.image_size, image_min_side=0.0)
    p = {"params": run["params"]["params"]["head"]}
    apply = jax.jit(jm.apply)

    def jrun(params, dt):
        outs = [apply(params, jnp.asarray(b.images[i:i + 1].numpy(), dt),
                      jnp.asarray(rc[i:i + 1].numpy()),
                      jnp.asarray(b.sorted_kept[i:i + 1].numpy()),
                      jnp.asarray(int(run["n_virtual"][i])))
                for i in range(2)]
        return (jnp.concatenate([o[0] for o in outs]),
                jnp.stack([o[1] for o in outs]))
    want_b, want_f = jrun(_bf16(p), BF), jrun(p, jnp.float32)
    assert want_b[0].dtype == BF
    _held(got[0], want_b[0], want_f[0], "head features")
    _held(got[1], want_b[1], want_f[1], "head empty-slot row")


# ------------------------------------------------------------- LiDAR


def _jax_branch_params(run):
    return {"params": run["params"]["params"]["backbone"]}


def test_column_conv1_in_bfloat16(run):
    """Compaction, the bfloat16 tap matmul, K1's plain version (float32
    row statistics) and the norm: (B, nx, ny, 5, 64) bfloat16."""
    port, b = run["port"], run["tbatch"]
    conv1 = port.backbone.cml.conv1
    vfeat = run["vfeat"]
    with torch.no_grad():
        got = torch.func.functional_call(
            conv1, cast_for_compute(conv1, True),
            (vfeat.bfloat16(), b.coords, b.vmask))
    assert got.dtype == torch.bfloat16
    jm = JaxConv1(64, 128, CFG.voxel_shape, d_last=True)
    p = {"params": run["params"]["params"]["backbone"]["cml"]["conv1"]}
    apply = jax.jit(jm.apply)

    def jrun(params, dt):
        return _per_sample(lambda f, c, m: apply(
            params, jnp.asarray(f, dt), jnp.asarray(c), jnp.asarray(m)),
            vfeat.numpy(), b.coords.numpy(), b.vmask.numpy())
    want_b = jrun(_bf16(p), BF)
    assert want_b.dtype == BF
    _held(got, want_b, jrun(p, jnp.float32), "column conv1")


def test_lidar_branch_in_bfloat16(run):
    """VoxelNetBranchPM on the fused 23-channel inputs in bfloat16."""
    port, b = run["port"], run["tbatch"]
    bb = port.backbone
    ins = (run["x"], b.sorted_kept, b.sorted_seg, b.counts, b.coords,
           b.vmask, run["z0"])
    with torch.no_grad():
        got = torch.func.functional_call(
            bb, cast_for_compute(bb, True),
            (ins[0].bfloat16(), *ins[1:6], ins[6].bfloat16()))
    assert got[0].dtype == torch.bfloat16
    jm = JaxBranch(CFG.voxel_shape, samples_per_voxel=8, cml_mode="column",
                   rpn_trunk=CFG.rpn_trunk)
    apply = jax.jit(make_apply(jm, run["jcfg"]))
    arrays = [jnp.asarray(t.numpy()) for t in ins]

    def jrun(params, dt):
        a = list(arrays)
        a[0], a[6] = a[0].astype(dt), a[6].astype(dt)
        return apply(params, *a)
    p = _jax_branch_params(run)
    want_b, want_f = jrun(_bf16(p), BF), jrun(p, jnp.float32)
    _held(got[0], want_b[0], want_f[0], "branch score")
    _held(got[1], want_b[1], want_f[1], "branch reg")


# ------------------------------------------------------------- model


def _jax_maps(run, use_bf16):
    apply = make_apply(run["model"], run["jcfg"])
    return jax.jit(lambda p, bt: apply(
        jax_cast(p, use_bf16),
        *_model_inputs(jax_castb(bt, use_bf16), True)))(run["params"],
                                                        run["jbatch"])


def test_whole_model_forward_in_bfloat16(run):
    with torch.no_grad():
        got = forward(run["port"], run["tbatch"], CFG, True)
    want_b, want_f = _jax_maps(run, True), _jax_maps(run, False)
    assert want_b[0].dtype == BF and got[0].dtype == torch.bfloat16
    assert got[1].dtype == torch.bfloat16
    _held(got[0], want_b[0], want_f[0], "score")
    _held(got[1], want_b[1], want_f[1], "reg")


def test_output_dtypes_follow_jax_lidar_only_is_float32(run):
    """JAX's LiDAR-only branch promotes its bfloat16 parameters against
    the float32 point features: float32 maps.  So does the port's."""
    jm = JaxBranch(CFG.voxel_shape, samples_per_voxel=8, cml_mode="column",
                   rpn_trunk=CFG.rpn_trunk)
    inputs = _model_inputs(jax_castb(run["jbatch"], True), False)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            *[a[:1] for a in inputs])
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, BF), shapes)
    out = jax.eval_shape(make_apply(jm, run["jcfg"]), params, *inputs)
    assert out[0].dtype == out[1].dtype == jnp.float32
    lidar = build_model(CFG, seed=0, device="cpu", with_images=False)
    with torch.no_grad():
        score, reg = forward(lidar, run["tbatch"], CFG, False)
    assert score.dtype == reg.dtype == torch.float32
    assert next(lidar.parameters()).dtype == torch.float32


# ------------------------------------------------------------- train step


@pytest.fixture(scope="module")
def step_run(run):
    """One bfloat16 train step on each side (and JAX's float32 step), the
    same weights, targets and voxelizer shuffle."""
    rng = np.random.default_rng(4)
    frames = [synthetic_frame(rng, CFG, num_cars=3, num_points=n,
                              yaw_range=(0.0, 0.0))
              for n in (900, 1500)]
    from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
    from mvxnet_makise_tpu_torch.train.loop import (
        collate,
        preprocess_train_frame,
    )

    arrays = [preprocess_train_frame(
        KittiFrame(f"f{i}", f[0], f[2], f[1], {"Car": f[3]}), CFG, None,
        np.random.default_rng(i)) for i, f in enumerate(frames)]
    pts, nums, imgs, gts, gms, gcs = (t.numpy() for t in collate(
        arrays, torch.device("cpu")))
    key = jax.random.key(5)
    perm = np.stack([np.asarray(jax.random.permutation(k, CFG.max_points))
                     for k in jax.random.split(key, 2)])
    anchors = create_anchors(CFG.feature_map_shape, CFG.velo_range,
                             CFG.anchor_sizes)
    apply_fn = make_apply(run["model"], run["jcfg"])
    out = {}
    for use_bf16 in (True, False):
        jcfg = run["jcfg"].replace(use_bf16=use_bf16)

        def step(p, pts, nums, imgs, gts, gms, gcs, jcfg=jcfg):
            batch = jax_batch(pts, nums, imgs, gts, gms, jcfg,
                              shuffle_key=key, gt_classes=gcs)
            targets = jax_assign_batch(batch, jcfg)
            return jax.value_and_grad(
                lambda q: jax_compute_loss(q, batch, targets, anchors,
                                           apply_fn, jcfg, True),
                has_aux=True)(p)
        (loss, metrics), grads = jax.jit(step)(
            run["params"], *map(jnp.asarray, (pts, nums, imgs, gts, gms,
                                              gcs)))
        out[use_bf16] = dict(loss=float(loss),
                             num_pos=float(metrics["num_pos"]),
                             grads=mvxnet_state(jax.device_get(
                                 grads)["params"]))
    port = build_model(CFG, seed=None, device="cpu")
    load_jax_params(port, run["params"])
    port.train()
    state = TrainState.create(CFG, port)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    batch = frames_to_batch(
        torch.from_numpy(pts), torch.from_numpy(nums),
        torch.from_numpy(imgs), CFG, gt_boxes=torch.from_numpy(gts),
        gt_mask=torch.from_numpy(gms), gt_classes=torch.from_numpy(gcs),
        perm=torch.from_numpy(perm))
    metrics = make_train_step(CFG, torch.from_numpy(anchors))(state, batch)
    return dict(jax=out, port=metrics, state=state, before=before,
                params=run["params"])


def test_bf16_train_step_loss_and_master_gradients(step_run):
    """Loss and every trainable float32 master's gradient (norm distance
    per parameter) within FACTOR times JAX's bfloat16-to-float32
    distance."""
    jb16, jf32 = step_run["jax"][True], step_run["jax"][False]
    got = step_run["port"]
    assert float(got["num_pos"]) == jb16["num_pos"] > 0
    d_port = abs(float(got["total_loss"]) - jb16["loss"])
    d_jax = abs(jb16["loss"] - jf32["loss"])
    assert 0 < d_jax and d_port <= FACTOR * d_jax, (d_port, d_jax)
    checked = 0
    for name, p in step_run["state"].model.named_parameters():
        if "extractor" in name:
            assert p.grad is None
            continue
        assert p.dtype == p.grad.dtype == torch.float32, name
        g = p.grad.double().numpy()
        wb = np.asarray(jb16["grads"][name], np.float64)
        wf = np.asarray(jf32["grads"][name], np.float64)
        d_port, d_jax = (np.linalg.norm(g - wb), np.linalg.norm(wb - wf))
        assert d_port <= FACTOR * d_jax + 1e-6 * np.linalg.norm(wb), name
        checked += 1
    assert checked == len([k for k in jb16["grads"] if "extractor" not in k])


def test_bf16_train_step_updates_the_float32_masters(step_run):
    """AdamW (eps = cfg.eps = 1e-3 under bfloat16) updates the float32
    masters from their gradients as optax's adamw does; the extractor is
    bit-unchanged."""
    state, before = step_run["state"], step_run["before"]
    model = state.model
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert CFG.eps == 1e-3
    # the trainable half of JAX's make_optimizer
    tx = optax.adamw(CFG.learning_rate, eps=CFG.eps)
    params = {n: jnp.asarray(before[n].numpy()) for n in grads}
    g = {n: jnp.asarray(v.numpy()) for n, v in grads.items()}
    updates, _ = tx.update(g, tx.init(params), params)
    want = optax.apply_updates(params, updates)
    for name, value in model.state_dict().items():
        assert value.dtype == torch.float32, name
        if "extractor" in name:
            assert torch.equal(value, before[name]), name
            continue
        np.testing.assert_allclose(value.numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
