"""PyTorch port: the five sub-stage tools ``bench_kernels``,
``bench_micro``, ``bench_branch``, ``bench_image`` and ``bench_resnet``.

At the tiny configuration of ``tests/test_torch_profile_tools.py``
(``--batch 2 --iters 1 --device cpu``) each tool prints one record per
row of its ``STAGES``/``BENCHES``, in order, on the CPU; on the default
device without a card each raises instead of running on the host.  Then
what the rows compute:

* ``bench_resnet``'s ``fpn`` cut is ``ResNet50FPN``'s output, and each
  earlier cut the intermediate a forward hook sees there, bit for bit in
  float32;
* ``bench_branch``'s ``svfe->vfeat`` against JAX's ``SVFEOnly``
  composition (``tools/bench_branch.py:74-90``, rebuilt here from
  ``PointSVFE``, ``DenseReluNormVirtualWeighted`` and ``_segment_max``:
  the JAX tool builds the full-width model when imported) in float64 on
  the same weights (``models/weights.load_jax_params``), to 1e-10;
* ``bench_branch``'s ``full branch column`` is the LiDAR-only model's
  output as ``train/step.forward`` computes it, and ``bench_image``'s
  ``head`` the fused model's ``PointImageHead`` output on its forward,
  bit for bit; ``fusion_mlp`` on the ``gather`` row's output is the head;
  ``bench_branch``'s dense rows keep the model's norm scope;
* ``bench_micro``'s merge row, composed from conv1's weight and bias, is
  the merge ``ColumnConv1ReluNorm`` runs before its norm, bit for bit.
"""

import contextlib
import copy
import io
import json

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.models.blocks import (
    DenseReluNormVirtualWeighted as JaxDenseVirtualWeighted,
)
from mvxnet_makise_tpu.models.voxelnet_pm import _NEG
from mvxnet_makise_tpu.models.voxelnet_pm import PointSVFE as JaxPointSVFE
from mvxnet_makise_tpu.models.voxelnet_pm import (
    VoxelNetBranchPM as JaxBranch,
)
from mvxnet_makise_tpu.models.voxelnet_pm import (
    _segment_max as jax_segment_max,
)
from mvxnet_makise_tpu.train.state import per_sample_apply
from mvxnet_makise_tpu_torch.config import load_config
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.resnet_fpn import ResNet50FPN
from mvxnet_makise_tpu_torch.models.voxelnet import ColumnConv1ReluNorm
from mvxnet_makise_tpu_torch.models.weights import (
    init_weights,
    load_jax_params,
)
from mvxnet_makise_tpu_torch.ops.column_merge import merge_taps_fused
from mvxnet_makise_tpu_torch.tools import (
    bench_branch,
    bench_image,
    bench_kernels,
    bench_micro,
    bench_resnet,
)
from mvxnet_makise_tpu_torch.tools.profile_components import (
    synthetic_batch,
)
from mvxnet_makise_tpu_torch.train.step import (
    forward,
    frames_to_batch,
    lidar_inputs,
)
from test_torch_profile_tools import TINY

# each tool: the constant naming its rows, its records' name key
TOOLS = {bench_kernels: ("BENCHES", "kernel"),
         bench_micro: ("STAGES", "stage"),
         bench_branch: ("STAGES", "stage"),
         bench_image: ("STAGES", "stage"),
         bench_resnet: ("STAGES", "stage")}
SVFE_TOL = 1e-10


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "tiny.yaml"
    path.write_text(TINY)
    return str(path)


def _cfg(tiny, **fields):
    return load_config(tiny, batch_size=2, **fields)


def _outputs(rows):
    """Each row's output, called as the row comes (a tool's generator
    frees what its earlier rows took once it moves on)."""
    with torch.no_grad():
        return {r.name: r.fn() for r in rows}


@pytest.mark.parametrize("tool", list(TOOLS), ids=lambda t: t.__name__)
def test_tool_prints_every_row_in_order_on_the_cpu(tool, tiny):
    constant, key = TOOLS[tool]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tool.main(["--device", "cpu", "--config", tiny, "--batch",
                          "2", "--iters", "1"]) == 0
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [r[key] for r in recs] == list(getattr(tool, constant))
    for r in recs:
        assert r["device"] == "cpu" and r["ms_per_batch"] > 0
        assert r["jax"] and r["first_call_s"] > 0
        assert r.get("route", "plain") == "plain"
    if tool is bench_resnet:
        assert sum(r["delta_ms"] for r in recs) == pytest.approx(
            recs[-1]["ms_per_batch"])


@pytest.mark.parametrize("tool", list(TOOLS), ids=lambda t: t.__name__)
def test_tool_refuses_the_card_it_does_not_have(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(["--iters", "1"])


def test_bench_resnet_cuts_are_the_forwards_intermediates():
    net = ResNet50FPN()
    init_weights(net, torch.Generator().manual_seed(0))
    net.eval().requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 3, 64, 96)).astype(np.float32))
    seen = {}

    def keep(name, arg):
        def hook(module, args, out):
            seen[name] = args[0] if arg else out
        return hook
    hooks = [net.get_submodule(name).register_forward_hook(
        keep(stage, not after))
        for stage, (name, after) in bench_resnet.CUTS.items()]
    with torch.no_grad():
        want = net(x)
    for h in hooks:
        h.remove()
    got = _outputs(bench_resnet.rows(net, x))
    assert list(got) == list(bench_resnet.STAGES)
    assert len(got["fpn"]) == len(want) == 3
    assert all(torch.equal(a, b) for a, b in zip(got["fpn"], want))
    for stage in bench_resnet.CUTS:
        assert torch.equal(got[stage], seen[stage]), stage


class _JaxSVFEOnly(nn.Module):
    """JAX's ``SVFEOnly`` (``tools/bench_branch.py:74-90``).  Its tool
    applies it to the whole batch, which pools the norms' statistics over
    the batch; the model, and the port's row, normalize each sample
    alone (``norm_scope="sample"``), so the test applies it per sample
    (``train/state.per_sample_apply``)."""
    V: int
    T: int
    eps: float = 1e-6

    @nn.compact
    def __call__(self, points, kept, seg, counts, vmask, z0):
        V, T = self.V, self.T
        nv = jnp.clip(T - counts, 0, T).astype(points.dtype) * vmask
        x, z = JaxPointSVFE(self.eps, name="svfe")(points, kept, seg, z0,
                                                   nv, vmask, V)
        h, hz = JaxDenseVirtualWeighted(128, self.eps, name="fcn")(
            x, kept, z, nv, vmask)
        segmax = jax.vmap(lambda v, s, k: jax_segment_max(v, s, k, V))(
            h, seg, kept)
        vfeat = jnp.where((nv > 0)[..., None], jnp.maximum(segmax, hz),
                          segmax)
        return jnp.where(vmask[..., None] & (vfeat > _NEG / 2), vfeat, 0.0)


def _jax_branch_params(cfg, rng):
    """Random float32 weights in JAX's LiDAR-only parameter tree, from
    numpy (the port's float32 parameters hold them exactly)."""
    P, V = cfg.max_points, cfg.max_voxels
    model = JaxBranch(cfg.voxel_shape, anchors_per_loc=cfg.anchors_per_loc,
                      samples_per_voxel=cfg.samples_per_voxel,
                      cml_mode="column")
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


def test_bench_branch_svfe_row_matches_jax_in_float64(tiny):
    cfg = _cfg(tiny, use_bf16=False)
    params = _jax_branch_params(cfg, np.random.default_rng(1))
    model = build_model(cfg, seed=None, device="cpu", with_images=False)
    load_jax_params(model, params)
    model = model.double()
    batch = frames_to_batch(*synthetic_batch(cfg, torch.device("cpu")),
                            cfg)
    got = _outputs(bench_branch.rows(cfg, model, batch))
    assert list(got) == list(bench_branch.STAGES)
    assert all(v is not None for v in got.values())

    pf7, kept, seg, counts, _, vmask = lidar_inputs(batch,
                                                    cfg.samples_per_voxel)
    args = [np.asarray(t) for t in (pf7.double(), kept, seg, counts, vmask)]
    with jax.enable_x64(True):
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         params["params"])
        svfe = _JaxSVFEOnly(cfg.max_voxels, cfg.samples_per_voxel)
        want = np.asarray(per_sample_apply(svfe.apply)(
            {"params": {"svfe": p["svfe"], "fcn": p["fcn"]}},
            *(jnp.asarray(a) for a in args),
            jnp.zeros((*batch.vmask.shape, 7), jnp.float64)))
    vfeat = got["svfe->vfeat"].numpy()
    assert vfeat.dtype == np.float64 and np.abs(want).max() > 0
    assert np.abs(vfeat - want).max() <= SVFE_TOL * np.abs(want).max()


def _hold_branch_rows(cfg):
    """``bench_branch``'s whole-branch rows against the LiDAR-only
    model's forward at ``cfg``: the column form bit for bit, the dense
    form on the same weights within 1e-4."""
    model = build_model(cfg, seed=0, device="cpu", with_images=False)
    batch = frames_to_batch(*synthetic_batch(cfg, torch.device("cpu")),
                            cfg)
    got = _outputs(bench_branch.rows(cfg, model, batch))
    with torch.no_grad():
        score, _ = forward(model, batch, cfg, with_images=False)
    assert torch.equal(got["full branch column"], score)
    torch.testing.assert_close(got["full branch dense3d"], score,
                               rtol=1e-4, atol=1e-4)


def test_bench_branch_full_column_row_is_the_lidar_only_model(tiny):
    _hold_branch_rows(_cfg(tiny, use_bf16=False))


def test_bench_branch_dense_rows_follow_the_norm_scope(tiny):
    # batch-wide statistics differ from per-sample ones on these frames,
    # so a dense CML left at sample scope misses the model's output
    _hold_branch_rows(_cfg(tiny, use_bf16=False, norm_scope="batch"))


@pytest.mark.parametrize("use_bf16", [False, True])
def test_bench_micro_merge_row_is_the_column_conv1_merge(tiny, use_bf16):
    cfg = _cfg(tiny, use_bf16=use_bf16)
    rng = np.random.default_rng(2)
    conv1 = ColumnConv1ReluNorm(128, bench_micro.CONV1_FEATURES,
                                cfg.voxel_shape)
    with torch.no_grad():
        for p in (conv1.conv.weight, conv1.conv.bias):
            p.copy_(torch.from_numpy(rng.normal(0, 0.05, tuple(p.shape))))
    frames = synthetic_batch(cfg, torch.device("cpu"))
    batch = frames_to_batch(*frames, cfg)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    vfeat = (torch.from_numpy(rng.normal(size=(*batch.vmask.shape, 128)))
             .to(dtype) * batch.vmask[..., None])
    got = _outputs(bench_micro.rows(cfg, conv1, frames, vfeat))
    assert list(got) == list(bench_micro.STAGES)
    with torch.no_grad():
        want = merge_taps_fused(*conv1.merge_inputs(
            vfeat, batch.coords, batch.vmask), cfg.voxel_shape)
    out, stats = got["merge (+bias/relu/stats)"]
    assert out.dtype == dtype and float(out.abs().max()) > 0
    assert torch.equal(out, want[0]) and torch.equal(stats, want[1])


def test_bench_image_head_row_is_the_models_head(tiny):
    cfg = _cfg(tiny)
    assert cfg.use_bf16
    model = build_model(cfg, seed=0, device="cpu")
    batch = frames_to_batch(*synthetic_batch(cfg, torch.device("cpu")),
                            cfg)
    seen = []
    hook = model.head.register_forward_hook(
        lambda module, args, out: seen.append(out))
    with torch.no_grad():
        forward(model, batch, cfg, with_images=True)
    hook.remove()
    head = copy.deepcopy(model.head).to(torch.bfloat16)
    got = _outputs(bench_image.rows(cfg, head, batch))
    assert list(got) == list(bench_image.STAGES)
    (want,) = seen
    for a, b, c in zip(got["head"], want, got["fusion_mlp"]):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b) and torch.equal(a, c)
