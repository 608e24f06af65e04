"""PyTorch port: the measurement tools ``bench_host``,
``profile_components`` and ``profile_train`` on the CPU.

``bench_host`` times the C++ host feed against numpy: on its own inputs
the two crops agree, and its JSON records carry the JAX tool's names and
keys.  The two profilers run at a tiny configuration (``--device cpu
--config``, bfloat16 as their default configuration) with one iteration
and print one record per stage, in order, each on ``"device": "cpu"``;
on the default device without a card they raise instead of running on
the host.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data import native
from mvxnet_makise_tpu_torch.data.synthetic import toy_calib
from mvxnet_makise_tpu_torch.tools import (
    bench_host,
    profile_components,
    profile_train,
)

TINY = """\
velo_range: [0.0, -8.0, -3.0, 12.8, 8.0, 1.0]
voxel_shape: [32, 40, 10]
image_size: [64, 96]
image_min_side: 0
max_points: 1024
max_voxels: 256
samples_per_voxel: 8
assign_window: 6
use_bf16: true
"""


def _records(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(args) == 0
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


def test_bench_host_native_equals_numpy():
    cfg = Config()
    rng = np.random.default_rng(0)
    n = 20000
    pts = np.stack([rng.uniform(-10, 80, n), rng.uniform(-50, 50, n),
                    rng.uniform(-4, 2, n), rng.uniform(0, 1, n)],
                   -1).astype(np.float32)
    calib = toy_calib(cfg.image_size)
    assert native.available()
    got = native.crop_project(pts, calib, cfg.velo_range, cfg.image_size)
    want = native.crop_project_numpy(pts, calib, cfg.velo_range,
                                     cfg.image_size)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_bench_host_records_carry_jax_names():
    from mvxnet_makise_tpu.tools import bench_host as jax_bench_host

    args = ["--iters", "1", "--points", "5000", "--batch", "2", "--busy",
            "1"]
    port = _records(bench_host.main, args)
    jax_recs = _records(jax_bench_host.main, args)
    assert [(r["bench"], sorted(r)) for r in port] == [
        (r["bench"], sorted(r)) for r in jax_recs]
    assert [r["bench"] for r in port] == list(bench_host.BENCHES)
    assert all(v > 0 for r in port for k, v in r.items()
               if k.endswith("ms"))


@pytest.mark.parametrize("tool", [profile_components, profile_train])
def test_profiler_prints_every_stage_on_the_cpu(tool, tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY)
    recs = _records(tool.main, ["--device", "cpu", "--config", str(cfg),
                                "--iters", "1", "--batch", "2"])
    stages = [r for r in recs if "stage" in r]
    assert [r["stage"] for r in stages] == list(tool.STAGES)
    for r in stages:
        assert r["device"] == "cpu"
        assert r["ms_per_batch"] > 0
        assert r["ms_per_frame"] == pytest.approx(r["ms_per_batch"] / 2)
    assert any("gflop_per_batch" in r for r in stages)
    if tool is profile_train:
        assert recs[-1] == profile_train.NOTE


def test_profile_stage_names_follow_jax():
    """JAX's ``fpn_gather_raw4`` and ``..._fused`` are two formulations
    of the port's one ``fpn_gather``; its ``fusion_mlp_full`` is the
    other statistics formulation of ``fusion_mlp_masked``."""
    assert profile_components.STAGES == (
        "voxelize", "resnet_fpn", "image_head_total", "fpn_gather",
        "fusion_mlp_masked", "voxelnet_branch", "full_model")
    assert profile_train.STAGES == (
        "voxelize_assign", "loss_value", "loss_grad", "full_step",
        "merge_fwd", "merge_fwd_plus_bwd")


@pytest.mark.parametrize("tool", [profile_components, profile_train])
def test_profiler_refuses_the_card_it_does_not_have(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--iters", "1"])
