"""PyTorch port: the public surface it shares with the JAX package.

``config.parse_cli`` gives the same ``Config`` and ``Namespace`` as JAX's
on the same arguments; ``data.native.crop_range`` keeps the same rows as
JAX's, by the C++ route and by the numpy route it takes without g++; and
every name a JAX package ``__init__`` re-exports is re-exported by the
port's counterpart under the same name, or listed below with the port's
name for it and the reason it differs.
"""

import ast
import dataclasses
import importlib
import os

import numpy as np
import pytest

from mvxnet_makise_tpu import config as jax_config
from mvxnet_makise_tpu.data import native as jax_native
from mvxnet_makise_tpu_torch import config
from mvxnet_makise_tpu_torch.data import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("with_yaml", [False, True], ids=["reference",
                                                           "yaml"])
def test_parse_cli_matches_jax(tmp_path, with_yaml):
    if with_yaml:
        path = tmp_path / "c.yaml"
        path.write_text("voxelshape: [32, 40, 10]\nsamplenum: 8\n"
                        "image_min_side: 0\nbatch_size: 2\n")
        argv = ["/data/kitti", "--config", str(path), "--batch-size", "3",
                "--bf16", "-n", "2"]
    else:
        argv = ["/data/kitti", "-n", "5", "-r", "3"]
    cfg, args = config.parse_cli(argv)
    want_cfg, want_args = jax_config.parse_cli(argv)
    assert vars(args) == vars(want_args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert cfg.data_root == "/data/kitti"
    if with_yaml:
        assert cfg.batch_size == 3 and cfg.use_bf16
        assert cfg.voxel_shape == (32, 40, 10) and cfg.num_epochs == 2
    else:
        assert cfg.num_epochs == 5 and args.resume == 3


VELO_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)


def _boundary_cloud(n=5000):
    """tests/test_native.py's cloud with points planted on the bounds:
    the low edge of every axis is kept, the high edge dropped."""
    rng = np.random.default_rng(0)
    pts = np.zeros((n, 5), dtype=np.float32)
    pts[:, 0] = rng.uniform(-10, 80, n)
    pts[:, 1] = rng.uniform(-50, 50, n)
    pts[:, 2] = rng.uniform(-4, 2, n)
    pts[:, 3] = rng.uniform(0, 1, n)
    pts[:, 4] = 7.0                         # an extra column, cut off
    pts[0, :3] = [0.0, -40.0, -3.0]
    pts[1, :3] = [np.float32(70.4), 0.0, 0.0]
    pts[2, :3] = [10.0, np.float32(40.0), 0.0]
    pts[3, :3] = [10.0, 0.0, np.float32(1.0)]
    pts[4, :3] = [np.float32(70.4) - np.float32(1e-5), 39.99, 0.99]
    return pts


@pytest.mark.parametrize("route", ["cpp", "numpy"])
def test_crop_range_matches_jax(monkeypatch, route):
    if route == "cpp" and not (native.available()
                               and jax_native.available()):
        pytest.fail("the C++ host feed did not build")
    pts = _boundary_cloud()
    want = jax_native.crop_range(pts, VELO_RANGE)
    if route == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
        assert np.array_equal(jax_native.crop_range(pts, VELO_RANGE), want)
    got = native.crop_range(pts, VELO_RANGE)
    assert got.dtype == np.float32 and got.shape[1] == 4
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:2], pts[[0, 4], :4])
    assert 100 < len(got) < len(pts)


# JAX names whose port goes by another name, or that have none: the JAX
# name -> (the port's counterpart "module:name" or None, why)
DIFFERENT = {
    "VFE": ("mvxnet_makise_tpu_torch.models.voxelnet_pm:PointVFE",
            "the slot-major encoder, computed over the voxel-sorted points"),
    "SVFE": ("mvxnet_makise_tpu_torch.models.voxelnet_pm:PointSVFE",
             "the slot-major encoder, computed over the voxel-sorted points"),
    "VoxelNetBranch": (
        "mvxnet_makise_tpu_torch.models.voxelnet_pm:VoxelNetBranchPM",
        "the slot-major branch computes VoxelNetBranchPM's function on its "
        "parameter tree"),
    "ImageFeatureFusion": (
        "mvxnet_makise_tpu_torch.models.image_head:PointImageFusion",
        "the slot-major fusion MLP, computed over the points"),
    "ImageHead": ("mvxnet_makise_tpu_torch.models.image_head:PointImageHead",
                  "the slot-major image head, computed over the points"),
    "MVXNet": ("mvxnet_makise_tpu_torch.models.mvxnet:MVXNetPM",
               'fusion_mode "slot": build_model builds MVXNetPM'),
    "MVXNetPointFusion": ("mvxnet_makise_tpu_torch.models.mvxnet:MVXNetPM",
                          'fusion_mode "point": build_model builds MVXNetPM'),
    "scatter_voxels_to_conv1_bands": (
        None, 'a TPU layout form (cml_mode "banded" builds the column CML)'),
    "bilinear_gather_fpn": ("mvxnet_makise_tpu_torch.ops.gather:fpn_gather",
                            "K2's wrapper, batched"),
    "bilinear_gather_fpn_batch": (
        "mvxnet_makise_tpu_torch.ops.gather:fpn_gather", "K2's wrapper"),
}

PACKAGES = ["", ".models", ".ops", ".eval", ".train", ".data", ".geometry",
            ".parallel", ".utils"]


def _reexports(path) -> list:
    """The names an ``__init__.py`` imports, read from its source."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


@pytest.mark.parametrize("sub", PACKAGES, ids=[s or "root" for s in PACKAGES])
def test_port_reexports_the_jax_names(sub):
    jax_init = os.path.join(ROOT, "mvxnet_makise_tpu", *sub.split(".")[1:],
                            "__init__.py")
    names = _reexports(jax_init)
    assert names
    port = importlib.import_module("mvxnet_makise_tpu_torch" + sub)
    for name in names:
        if name in DIFFERENT:
            counterpart = DIFFERENT[name][0]
            assert not hasattr(port, name), name
            if counterpart is not None:
                module, attr = counterpart.split(":")
                assert hasattr(importlib.import_module(module), attr), name
        else:
            assert hasattr(port, name), f"{sub or 'root'}: {name}"
    if not sub:
        import mvxnet_makise_tpu

        assert port.__version__ == mvxnet_makise_tpu.__version__ == "0.1.0"
    if sub == ".eval":
        assert port.decode_batch.__module__.endswith("eval.decode")
