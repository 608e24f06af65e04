"""PyTorch port: the parallel package over ``torch.distributed`` (gloo on
the CPU), against the single-process port and JAX's mesh.

Ranks are spawned processes joined to a FileStore in the test's temporary
directory, each with its own time limit; they import neither JAX nor the
JAX package (JAX is imported inside the test functions of this process
only).  The tiny configuration of ``tests/test_reference_oracle_model.py``
(grid 32x40x10, 64x96 images), float64, the reference RPN trunk (whose
256-channel convolutions and deconvolutions, and the ResNet's, the model
axis cuts):

* world 2, mesh (2, 1): two mesh train steps equal the single-process
  steps, in sample and in batch norm scope: the first step's loss,
  metrics and gradients to 1e-10, the parameters after the second and its
  loss to 1e-6 (AdamW amplifies the last-bit differences, see
  AFTER_UPDATE_TOL) (batch scope pools its statistics over the data ranks; the
  same step without that pooling is shown to miss); a non-finite loss on
  one rank skips the update on both; ``Detector(mesh=...)`` returns the
  whole batch on every rank, equal to the single-process port (fused
  model) and to JAX's mesh ``Detector`` (LiDAR-only model, float64 on
  both sides, float32 decoding, within ``tests/test_torch_serve_api.py``'s
  float32 tolerances); a batch that does not split raises;
* world 4, mesh (2, 2): the maps of each rank's rows and every
  parameter's gradient after a mesh step equal the single-process port's
  to 1e-10 (the gathered slices' gradients are not scaled by the model
  axis, and the replicated layers before a cut layer get every slice's
  part).
"""

import copy
import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
from mvxnet_makise_tpu_torch.models.blocks import set_norm_scope
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.parallel import (
    make_mesh,
    param_sharding,
    shard_batch,
    shard_params,
)
from mvxnet_makise_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_distributed,
    is_primary,
)
from mvxnet_makise_tpu_torch.parallel.mesh import axis_index, sharded_layers
from mvxnet_makise_tpu_torch.parallel.tensor import ColumnParallel
from mvxnet_makise_tpu_torch.serve import Detector
from mvxnet_makise_tpu_torch.train.loop import collate, preprocess_train_frame
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    _assign_batch,
    compute_loss,
    forward,
    frames_to_batch,
    make_train_step,
)

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=4, samples_per_voxel=8,
          assign_window=6, image_min_side=0)
CFG = Config(**KW)
B = 4
# float64: what the mesh and the single process compute on the same
# parameters (maps, losses, metrics, gradients relative to each tensor's
# largest value); measured on a CPU at most 7e-12 (gradients), 4e-13
# (loss).  The two differ in the last bits only: a GEMM over 2 frames'
# rows rounds otherwise than over 4, and the untrained model's norms
# amplify that to ~1e-13.
TOL = 1e-10
# after an AdamW update: its first update of an entry is lr * g / (|g| +
# eps), which multiplies a gradient's absolute error by up to lr / eps =
# 1e3 where |g| << eps (cfg.eps 1e-6), and the next step's gradients are
# taken at those parameters; measured on a CPU: parameters 2.2e-7 apart
# after two steps, the second step's loss 4e-8 relative
AFTER_UPDATE_TOL = 1e-6
# seconds a spawned world may take before the test fails (the ``worlds``
# fixture takes ~100 s inside a full 6-worker tier-1 run on an 8-core CPU
# at load average ~11, 155-207 s at ~24), and the collectives' timeout
JOIN_S = 480
COLLECTIVE_S = 120


# -------------------------------------------------------------- data


def _train_arrays():
    """B synthetic frames with axis-aligned cars, as the step's padded
    tensors (points, num_points, images, gt boxes, mask, classes, perm)."""
    rng = np.random.default_rng(5)
    arrays = []
    for i in range(B):
        pts, calib, image, boxes = synthetic_frame(
            rng, CFG, num_cars=3, num_points=1000 + 100 * i,
            yaw_range=(0.0, 0.0))
        arrays.append(preprocess_train_frame(
            KittiFrame(f"f{i}", pts, image, calib, {"Car": boxes}), CFG,
            None, np.random.default_rng(i)))
    out = collate(arrays, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    perm = torch.stack([torch.randperm(CFG.max_points, generator=gen)
                        for _ in range(B)])
    return (*out, perm)


def _batch(arrays, dtype=torch.float64):
    pts, nums, imgs, gts, gms, gcs, perm = arrays
    return frames_to_batch(pts.to(dtype), nums, imgs.to(dtype), CFG,
                           gt_boxes=gts.to(dtype), gt_mask=gms,
                           gt_classes=gcs, perm=perm)


def _frames():
    rng = np.random.default_rng(7)
    return [synthetic_frame(rng, CFG, num_cars=2, num_points=n)[:3]
            for n in (900, 1500, 1200, 700)]


def _anchors(dtype=torch.float64):
    return torch.from_numpy(create_anchors(
        CFG.feature_map_shape, CFG.velo_range, CFG.anchor_sizes)).to(dtype)


_BUILT = {}


def _model(cfg, seed=1):
    """A float64 copy of the seeded model, its norms set to
    ``cfg.norm_scope`` (the ResNet's seeded initialization is drawn once
    per process)."""
    if seed not in _BUILT:
        _BUILT[seed] = build_model(CFG, seed=seed, device="cpu").double()
    return set_norm_scope(copy.deepcopy(_BUILT[seed]),
                          cfg.norm_scope).train()


def _steps(cfg, batch, mesh=None, n=2):
    """``n`` train steps (on the mesh when given): each step's metrics as
    floats, the first step's gradients, and the whole parameters after
    the last step."""
    model = _model(cfg)
    if mesh is not None:
        shard_params(model, mesh)
    state = TrainState.create(cfg, model)
    step = make_train_step(cfg, _anchors(), mesh=mesh)
    metrics, grads = [], None
    for _ in range(n):
        metrics.append({k: float(v.detach())
                        for k, v in step(state, batch).items()})
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None}
    return metrics, grads, {k: v.detach().clone()
                            for k, v in model.state_dict().items()}


def _unpooled_loss(cfg, batch, mesh):
    """The global loss of a mesh model whose batch-scope norms do not pool
    over the data ranks (what the step would compute without them)."""
    model = shard_params(_model(cfg), mesh)
    for m in model.modules():
        if hasattr(m, "stats_group"):
            m.stats_group = None
    with torch.no_grad():
        loss = compute_loss(model, batch, _assign_batch(batch, cfg),
                            _anchors(), cfg)[0]
    dist.all_reduce(loss, group=mesh.get_group("data"))
    return float(loss) / 2


def _dets(dets):
    return [(d.boxes, d.scores, d.classes) for d in dets]


# -------------------------------------------------------------- ranks


def _job_data(job):
    mesh = make_mesh((2, 1))
    arrays = job["arrays"]
    out = {"primary": is_primary(), "rank": dist.get_rank()}
    for scope in ("sample", "batch"):
        cfg = CFG.replace(norm_scope=scope)
        local = shard_batch(_batch(arrays), mesh)
        out[scope] = _steps(cfg, local, mesh)
        if scope == "batch":
            out["batch_unpooled"] = _unpooled_loss(cfg, local, mesh)
    # a non-finite loss on data rank 1 only: its scores made NaN
    local = shard_batch(_batch(arrays), mesh)
    model = _model(CFG)
    if axis_index(mesh, "data") == 1:
        model.backbone.rpn.register_forward_hook(
            lambda mod, args, maps: (maps[0] * float("nan"), maps[1]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState.create(CFG, shard_params(model, mesh))
    m = make_train_step(CFG, _anchors(), mesh=mesh)(state, local)
    out["nonfinite"] = dict(
        skipped=int(m["skipped_nonfinite"]), step=state.step,
        unchanged=all(torch.equal(v, before[k])
                      for k, v in model.state_dict().items()))
    # serving: the fused model and the LiDAR-only one on JAX's weights
    frames = job["frames"]
    det = Detector(CFG, _model(CFG, seed=2).eval(), score_threshold=0.0,
                   mesh=mesh)
    out["fused"] = _dets(det.detect_frames(frames))
    try:
        det.detect_frames(frames[:3])
        out["indivisible"] = "served"
    except ValueError as e:
        out["indivisible"] = str(e)
    lidar = build_model(CFG, seed=None, device="cpu", with_images=False)
    from mvxnet_makise_tpu_torch.models.weights import load_jax_params

    load_jax_params(lidar, job["lidar_params"])
    det = Detector(CFG, lidar.double(), with_images=False,
                   score_threshold=0.0,
                   mesh=mesh)
    out["lidar"] = _dets(det.detect_frames(frames))
    return out


def _job_model(job):
    mesh = make_mesh((2, 2))
    d = axis_index(mesh, "data")
    model = _model(CFG)
    shard_params(model, mesh)
    local = shard_batch(_batch(job["arrays"]), mesh)
    with torch.no_grad():
        maps = [t.clone() for t in forward(model, local, CFG, True)]
    state = TrainState.create(CFG, model)
    m = make_train_step(CFG, _anchors(), mesh=mesh)(state, local)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    twins = {n: (mod.kind, mod.rank, mod.width)
             for n, mod in model.named_modules()
             if isinstance(mod, ColumnParallel)}
    placed = {n: p.spec for n, p in param_sharding(model, mesh).items()}
    # a mesh Detector takes the whole weights of another model and
    # slices them
    det = Detector(CFG, _model(CFG).eval(), score_threshold=0.0, mesh=mesh)
    det.set_params(_model(CFG, seed=2).state_dict())
    return dict(data=d, model=axis_index(mesh, "model"), maps=maps,
                loss=float(m["total_loss"]), grads=grads, twins=twins,
                placed=placed, layers=_layer_twins(mesh),
                detections=_dets(det.detect_frames(job["frames"])))


def _layer_twins(mesh):
    """Each layer kind's column-parallel twin against the whole layer
    (seeded, float64, 256 outputs): output, and the gradients of the
    slice's weight and bias and of the input, under one loss."""
    from mvxnet_makise_tpu_torch.models.voxelnet import Conv3dParams
    from mvxnet_makise_tpu_torch.parallel.tensor import column_parallel

    group = mesh.get_group("model")
    torch.manual_seed(0)
    cases = {"linear": (torch.nn.Linear(8, 256), (3, 5, 8), {}),
             "conv2d": (torch.nn.Conv2d(8, 256, 3, 2, 1), (2, 8, 6, 7), {}),
             "deconv2d": (torch.nn.ConvTranspose2d(8, 256, 2, 2),
                          (2, 8, 3, 4), {}),
             "conv3d": (Conv3dParams(8, 256), (2, 8, 4, 5, 6),
                        dict(stride=(2, 1, 1), padding=(1, 1, 1)))}
    out = {}
    for kind, (layer, shape, kw) in cases.items():
        layer = layer.double()
        if kind == "conv3d":
            torch.nn.init.normal_(layer.weight, std=0.1)
            torch.nn.init.normal_(layer.bias, std=0.1)
        twin = column_parallel(layer, group)
        res = []
        for mod in (layer, twin):
            x = torch.randn(shape, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(1))
            x.requires_grad_(True)
            y = mod(x, **kw)
            (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
             .cos()).sum().backward()
            res.append((y.detach(), mod.weight.grad, mod.bias.grad, x.grad))
        out[kind] = (res, twin.rank, twin.width)
    return out


JOBS = {"data": _job_data, "model": _job_model}


def _rank_main(rank, world, store, out_dir, job):
    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world, rank, device="cpu",
                           timeout=timedelta(seconds=COLLECTIVE_S))
    try:
        result = JOBS[job["name"]](job)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world, out_dir, job):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(out_dir, "store"),
                               out_dir, job))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, out_dir):
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for i in hung:
        procs[i].kill()
        procs[i].join(10)
    assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"rank exit codes {codes}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def _jax_lidar():
    """JAX's LiDAR-only model for CFG (``VoxelNetBranchPM``, as JAX's
    ``build_model_and_state`` builds it) and seeded random weights of its
    tree (numpy; shapes from ``jax.eval_shape``, no compile)."""
    import jax
    import jax.numpy as jnp

    from mvxnet_makise_tpu.config import Config as JaxConfig
    from mvxnet_makise_tpu.models import VoxelNetBranchPM

    jcfg = JaxConfig(**KW)
    model = VoxelNetBranchPM(grid_shape=jcfg.voxel_shape,
                             anchors_per_loc=jcfg.anchors_per_loc,
                             samples_per_voxel=jcfg.samples_per_voxel,
                             remat=jcfg.remat,
                             scatter_backend=jcfg.scatter_backend,
                             cml_mode=jcfg.cml_mode,
                             rpn_trunk=jcfg.rpn_trunk)
    P, V = jcfg.max_points, jcfg.max_voxels
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, P, 7)),
        jnp.zeros((1, P), bool), jnp.full((1, P), V, jnp.int32),
        jnp.zeros((1, V), jnp.int32), jnp.zeros((1, V, 3), jnp.int32),
        jnp.zeros((1, V), bool))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape)
        return rng.normal(0, 0.1, leaf.shape)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: draw(p, a).astype(np.float32), shapes)
    return jcfg, model, params


def _data_refs(arrays, frames, jax_lidar):
    """The single-process references of the data-axis world: two steps in
    each scope, the fused Detector, and JAX's mesh Detector (LiDAR-only)."""
    jcfg, jmodel, jparams = jax_lidar
    ref = {scope: _steps(CFG.replace(norm_scope=scope), _batch(arrays))
           for scope in ("sample", "batch")}
    det = Detector(CFG, _model(CFG, seed=2).eval(), score_threshold=0.0)
    ref["fused"] = _dets(det.detect_frames(frames))
    import jax

    from mvxnet_makise_tpu.parallel.mesh import make_mesh as jax_mesh
    from mvxnet_makise_tpu.serve import Detector as JaxDetector

    with jax.enable_x64(True):
        jdet = JaxDetector(
            jcfg, jmodel, jax.tree.map(lambda a: a.astype(np.float64),
                                       jparams),
            with_images=False, score_threshold=0.0,
            mesh=jax_mesh((2, 1), jax.devices()[:2]))
        # JAX's mesh pipeline on the assembled batch in float64, as the
        # port's float64 detector computes (detect_frames would hand it
        # float32 points)
        pts, nums, imgs = det.assemble(frames)
        ref["lidar"] = _dets(jdet.stream_batches(
            [(pts.astype(np.float64), nums, imgs.astype(np.float64),
              len(frames))], len(frames)))
    return ref


def _model_refs(arrays, frames):
    """The single-process references of the model-axis world: maps, one
    step's loss and gradients, the layers the rule cuts, and a Detector
    on the seed-2 weights."""
    det = Detector(CFG, _model(CFG, seed=2).eval(), score_threshold=0.0)
    detections = _dets(det.detect_frames(frames))
    model = _model(CFG)
    batch = _batch(arrays)
    with torch.no_grad():
        maps = forward(model, batch, CFG, True)
    state = TrainState.create(CFG, model)
    m = make_train_step(CFG, _anchors())(state, batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return dict(maps=maps, loss=float(m["total_loss"]), grads=grads,
                layers=sharded_layers(model, 2), detections=detections)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """World 2 on a (2, 1) mesh and world 4 on a (2, 2) mesh, started
    together; the single-process references are computed here while
    their ranks run."""
    arrays, frames = _train_arrays(), _frames()
    jax_lidar = _jax_lidar()
    dirs = {name: str(tmp_path_factory.mktemp(name))
            for name in ("data", "model")}
    procs = {"data": _spawn(2, dirs["data"], dict(
                 name="data", arrays=arrays, frames=frames,
                 lidar_params=jax_lidar[2])),
             "model": _spawn(4, dirs["model"], dict(
                 name="model", arrays=arrays, frames=frames))}
    refs = {}
    try:
        refs["data"] = _data_refs(arrays, frames, jax_lidar)
        refs["model"] = _model_refs(arrays, frames)
    finally:
        ranks = {name: _join(p, dirs[name]) for name, p in procs.items()}
    return {name: (ranks[name], refs[name]) for name in procs}


@pytest.fixture(scope="module")
def data_run(worlds):
    return worlds["data"]


@pytest.fixture(scope="module")
def model_run(worlds):
    return worlds["model"]


# -------------------------------------------------------------- tests


def test_make_mesh_refuses_shapes_that_do_not_fit():
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((3, 1), devices=[0, 1])
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((2, 2), devices=[0, 1, 2])
    with pytest.raises(ValueError, match="not divisible"):
        global_mesh(model_axis=3, devices=[0, 1])
    with pytest.raises(RuntimeError, match="initialized"):
        make_mesh()


def test_initialize_distributed_single_process(monkeypatch, tmp_path):
    """No environment and no arguments: False, nothing initialized; NCCL
    without a card raises instead of falling back to gloo."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not dist.is_initialized() and is_primary()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                   backend="nccl", device="cpu")
        assert not dist.is_initialized()


def _jax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_sharded_weights_are_the_kernels_jax_shards():
    """The port's rule picks, through ``load_jax_params``' name map, the
    layers whose kernels JAX's ``param_sharding`` cuts on a (4, 2) mesh;
    JAX also cuts those layers' biases (the twins hold their slices) and
    the folded norms' biases of 256+ channels, which the port keeps
    replicated (the output they act on is gathered)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from mvxnet_makise_tpu.config import Config as JaxConfig
    from mvxnet_makise_tpu.models import MVXNetPM as JaxMVXNetPM
    from mvxnet_makise_tpu.parallel.mesh import make_mesh as jax_mesh
    from mvxnet_makise_tpu.parallel.mesh import (
        param_sharding as jax_param_sharding,
    )
    from mvxnet_makise_tpu_torch.models.weights import mvxnet_state

    jcfg = JaxConfig(**KW)
    jmodel = JaxMVXNetPM(grid_shape=jcfg.voxel_shape,
                         image_size=jcfg.image_size,
                         samples_per_voxel=jcfg.samples_per_voxel,
                         image_min_side=jcfg.image_min_side)
    P, V = jcfg.max_points, jcfg.max_voxels
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, P, 6)),
        jnp.zeros((1, P), bool), jnp.full((1, P), V, jnp.int32),
        jnp.zeros((1, V), jnp.int32), jnp.zeros((1, V, 3), jnp.int32),
        jnp.zeros((1, V), bool), jnp.zeros((1, *jcfg.image_size, 3)))
    specs = dict(_jax_paths(jax_param_sharding(
        shapes, jax_mesh((4, 2), jax.devices()[:8]))["params"]))
    # tag every leaf with its index, then map the tree to port names
    paths = list(_jax_paths(shapes["params"]))
    tagged = {}
    for i, (path, leaf) in enumerate(paths):
        node = tagged
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.full((1,) * len(leaf.shape), i, np.int64)
    port_name = {int(np.asarray(v).reshape(-1)[0]): k
                 for k, v in mvxnet_state(tagged).items()}
    cut = {paths[i][0] for i in range(len(paths))
           if specs[paths[i][0]].spec != PartitionSpec()}
    kernels = {p for p in cut if p[-1] == "kernel"}
    layer_biases = {p for p in cut if p[-1] == "bias"
                    and p[:-1] + ("kernel",) in kernels}
    norm_biases = {p for p in cut if p[-1] == "bias"
                   and p[:-1] + ("scale",) in specs}
    assert kernels and cut == kernels | layer_biases | norm_biases
    index = {p: i for i, (p, _) in enumerate(paths)}
    want = {port_name[index[p]] for p in kernels | layer_biases}
    model = build_model(CFG, seed=None, device="cpu")
    got = {f"{layer}.{leaf}" for layer in sharded_layers(model, 2)
           for leaf in ("weight", "bias")
           if f"{layer}.{leaf}" in dict(model.named_parameters())}
    assert got == want
    assert any(".rpn.deconv" in k for k in got)
    assert any("extractor" in k for k in got)


def _assert_metrics(got, want, tol, what):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (
            what, k, got[k], want[k])


def test_data_parallel_steps_match_single_process(data_run):
    """The first step's loss, metrics and gradients to TOL; the second
    step's and the parameters after it to AFTER_UPDATE_TOL (see its
    note)."""
    ranks, ref = data_run
    for scope in ("sample", "batch"):
        want_metrics, want_grads, want_params = ref[scope]
        for r in ranks:
            got_metrics, got_grads, got_params = r[scope]
            _assert_metrics(got_metrics[0], want_metrics[0], TOL, scope)
            _assert_metrics(got_metrics[1], want_metrics[1],
                            AFTER_UPDATE_TOL, scope)
            assert got_grads.keys() == want_grads.keys()
            for k, v in want_grads.items():
                torch.testing.assert_close(
                    got_grads[k], v, rtol=0,
                    atol=TOL * max(1.0, float(v.abs().max())),
                    msg=f"{scope} {k}")
            assert got_params.keys() == want_params.keys()
            for k, v in want_params.items():
                torch.testing.assert_close(got_params[k], v, rtol=0,
                                           atol=AFTER_UPDATE_TOL,
                                           msg=f"{scope} {k}")
    # without the pooled statistics batch scope computes another loss
    unpooled = ranks[0]["batch_unpooled"]
    assert abs(unpooled - ref["batch"][0][0]["total_loss"]) > 1e-4


def test_nonfinite_loss_on_one_rank_skips_every_rank(data_run):
    ranks, _ = data_run
    for r in ranks:
        assert r["nonfinite"] == dict(skipped=1, step=0, unchanged=True)
    assert [r["primary"] for r in ranks] == [True, False]


def _assert_same_dets(got, want):
    assert len(got) == len(want)
    for (gb, gs, gc), (wb, ws, wc) in zip(got, want):
        np.testing.assert_array_equal(gc, np.asarray(wc))
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gb, np.asarray(wb), rtol=0, atol=1e-5)


def test_mesh_detector_serves_the_whole_batch(data_run):
    """Every rank gets the whole batch's detections in frame order: the
    fused model's equal the single-process port's; a batch of 3 frames
    over 2 data ranks raises."""
    ranks, ref = data_run
    for r in ranks:
        assert len(r["fused"]) == B
        _assert_same_dets(r["fused"], ref["fused"])
        assert "does not split" in r["indivisible"]
    assert sum(len(s) for _, s, _ in ref["fused"]) > 0


def test_mesh_detector_matches_jax_mesh_detector(data_run):
    """The LiDAR-only model on JAX's weights: the port's mesh Detector
    against JAX's ``Detector(mesh=make_mesh((2, 1)))``, both in float64
    and decoding in float32 (in float32 the untrained model's maps sit
    ~6e-5 apart: the packages round otherwise)."""
    ranks, ref = data_run
    for r in ranks:
        _assert_same_dets(r["lidar"], ref["lidar"])
    assert sum(len(s) for _, s, _ in ref["lidar"]) > 0


def test_model_axis_matches_single_process(model_run):
    """Mesh (2, 2): each rank's maps are its rows of the single-process
    maps; after one mesh step every replicated parameter's gradient and
    every slice's gradient equal the single-process gradient to 1e-10."""
    ranks, ref = model_run
    assert {(r["data"], r["model"]) for r in ranks} == {
        (0, 0), (0, 1), (1, 0), (1, 1)}
    for r in ranks:
        rows = slice(2 * r["data"], 2 * r["data"] + 2)
        for got, want in zip(r["maps"], ref["maps"]):
            torch.testing.assert_close(got, want[rows], rtol=0, atol=TOL)
        assert abs(r["loss"] - ref["loss"]) <= TOL
        assert set(r["twins"]) == set(ref["layers"])
        assert r["grads"].keys() == ref["grads"].keys()
        for name, want in ref["grads"].items():
            layer, _, leaf = name.rpartition(".")
            got = r["grads"][name]
            if layer in r["twins"]:
                kind, rank, width = r["twins"][layer]
                dim = 1 if kind == "deconv2d" and leaf == "weight" else 0
                want = want.narrow(dim, rank * width, width)
                spec = r["placed"][name]
                assert spec == ((None, "model") if dim else ("model",))
            else:
                assert r["placed"][name] == ()
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, rtol=0, atol=TOL * scale,
                                       msg=name)
    assert any(k.startswith("backbone.rpn.deconv") for k in ref["layers"])


def test_each_layer_twin_matches_the_whole_layer(model_run):
    """Linear, Conv2d, ConvTranspose2d (output channels on dim 1 of its
    weight) and Conv3dParams: the gathered output equals the whole
    layer's, the slice's weight and bias gradients are the whole layer's
    slices (not scaled by the model axis), and the input's gradient sums
    every slice's part."""
    ranks, _ = model_run
    for r in ranks:
        for kind, (res, rank, width) in r["layers"].items():
            (y, gw, gb, gx), (ty, tgw, tgb, tgx) = res
            dim = 1 if kind == "deconv2d" else 0
            torch.testing.assert_close(ty, y, rtol=0, atol=1e-12, msg=kind)
            torch.testing.assert_close(
                tgw, gw.narrow(dim, rank * width, width), rtol=0,
                atol=1e-12, msg=kind)
            torch.testing.assert_close(
                tgb, gb.narrow(0, rank * width, width), rtol=0, atol=1e-12,
                msg=kind)
            torch.testing.assert_close(tgx, gx, rtol=0, atol=1e-10,
                                       msg=kind)


def test_mesh_detector_set_params_takes_the_whole_weights(model_run):
    """A (2, 2) mesh Detector given another model's whole state dict
    serves that model's detections (the single-process port's)."""
    ranks, ref = model_run
    for r in ranks:
        _assert_same_dets(r["detections"], ref["detections"])
    assert sum(len(s) for _, s, _ in ref["detections"]) > 0
