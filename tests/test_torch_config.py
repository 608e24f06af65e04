"""PyTorch port: Config parity with the JAX package, device policy, and
import isolation (the port and ``chip_smoke.py`` never pull in JAX or the
JAX package)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from mvxnet_makise_tpu.config import Config as JaxConfig
from mvxnet_makise_tpu.config import load_config as jax_load_config
from mvxnet_makise_tpu.ops.assign import create_anchors as jax_anchors
from mvxnet_makise_tpu.ops.assign import min_assign_window as jax_window
from mvxnet_makise_tpu_torch.config import Config, load_config
from mvxnet_makise_tpu_torch.device import resolve_device
from mvxnet_makise_tpu_torch.ops.assign import (
    create_anchors,
    min_assign_window,
)

TINY = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
            voxel_shape=(32, 40, 10), image_size=(64, 96),
            max_points=1024, max_voxels=256, samples_per_voxel=8,
            assign_window=6, image_min_side=0)


@pytest.mark.parametrize("kw", [{}, TINY,
                                {"target_classes": ("Car", "Pedestrian")},
                                {"use_bf16": True}])
def test_config_fields_and_derived_values_match_jax(kw):
    names = [f.name for f in dataclasses.fields(JaxConfig)]
    assert [f.name for f in dataclasses.fields(Config)] == names
    a, b = JaxConfig(**kw), Config(**kw)
    for n in names:
        assert getattr(a, n) == getattr(b, n), n
    for prop in ("num_classes", "rpn_trunk", "anchors_per_loc",
                 "num_anchors"):
        assert getattr(a, prop) == getattr(b, prop)


@pytest.mark.parametrize("kw", [{"norm_scope": "Sample"},
                                {"fusion_stats": "x"},
                                {"rpn_channels": (1, 2)},
                                {"assign_window": 1}])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        Config(**kw)


def test_load_config_reads_reference_keys(tmp_path):
    p = tmp_path / "config.yml"
    p.write_text("voxelshape: [32, 40, 10]\nsamplenum: 5\nimsize: "
                 "[64, 96]\nassign_window: 20\n")
    assert load_config(str(p)) == load_config(str(p), batch_size=1)
    j, t = jax_load_config(str(p)), load_config(str(p))
    assert t.voxel_shape == j.voxel_shape == (32, 40, 10)
    assert t.samples_per_voxel == j.samples_per_voxel == 5


def test_assign_helpers_match_jax():
    cfg = Config(**TINY)
    assert min_assign_window(cfg.feature_map_shape, cfg.velo_range,
                             (3.9, 1.6, 1.56), 0.45) == jax_window(
        cfg.feature_map_shape, cfg.velo_range, (3.9, 1.6, 1.56), 0.45)
    a = create_anchors((16, 20), cfg.velo_range,
                       ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73)))
    b = jax_anchors((16, 20), cfg.velo_range,
                    ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73)))
    assert (a == b).all()


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from mvxnet_makise_tpu_torch.serve import Detector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector.create(Config(**TINY))
    assert resolve_device("cpu").type == "cpu"


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL",
             "mvxnet_makise_tpu")


def test_import_leaves_jax_and_the_jax_package_out():
    """Every module of the port, and ``chip_smoke.py``: importing them
    loads none of the forbidden packages, and no import statement in them
    (at any depth, so also the ones a function runs late) names one."""
    import ast

    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import mvxnet_makise_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in {FORBIDDEN!r})
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr

    sources = [os.path.join(root, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(root, "mvxnet_makise_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(sources) > 40
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
