"""PyTorch port: the throughput bench (``tools/bench.py``) and its
supervisor (``utils/watchdog.py``) on the CPU.

Each mode runs as a user runs it (``python -m
mvxnet_makise_tpu_torch.tools.bench``, a supervised child) at a tiny
configuration: the last line is one JSON object whose metric name equals
the repository's ``bench.py`` ``_metric_name`` for the same flags, with no
``vs_baseline`` and ``upload_excluded`` false.  A failing child makes the
bench exit nonzero; the defaults are the reference's model (min side 800,
the reference RPN trunk); flags the port has no formulation for are
refused.  The six supervisor and watchdog tests of
``tests/test_bench_watchdog.py`` run against the port's copy (shorter
timeouts).
"""

import argparse
import importlib.util
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from mvxnet_makise_tpu_torch.models.voxelnet import REFERENCE_RPN_TRUNK
from mvxnet_makise_tpu_torch.tools import bench
from mvxnet_makise_tpu_torch.utils.watchdog import (
    PartialWriter,
    StageStall,
    StageWatchdog,
    supervise,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"velo_range": [0.0, -8.0, -3.0, 12.8, 8.0, 1.0],
        "voxel_shape": [32, 40, 10], "image_size": [64, 96],
        "max_points": 1024, "max_voxels": 256, "samples_per_voxel": 8,
        "assign_window": 6, "image_min_side": 0, "batch_size": 2,
        "use_bf16": True}


def _root_metric_name(**flags):
    """The repository bench.py's metric name for these flags."""
    spec = importlib.util.spec_from_file_location(
        "repo_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = argparse.Namespace(train=False, raw_only=False, lidar_only=False)
    vars(ns).update(flags)
    return mod._metric_name(ns)


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "tiny.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in TINY.items()))
    return str(path)


def _bench(*args, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", "mvxnet_makise_tpu_torch.tools.bench",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads(lines[-1]), proc.stderr


@pytest.mark.parametrize("flags", [
    {}, {"raw_only": True}, {"train": True}, {"lidar_only": True}],
    ids=["e2e", "raw-only", "train", "lidar-only"])
def test_each_mode_prints_one_json_line(tiny_yaml, flags):
    args = [f"--{k.replace('_', '-')}" for k in flags]
    rc, line, err = _bench("--config", tiny_yaml, "--device", "cpu",
                           "--iters", "2", "--warmup", "1", *args)
    assert rc == 0, err[-2000:]
    assert line["metric"] == _root_metric_name(**flags)
    assert line["value"] > 0 and line["unit"] == "frames/s"
    assert "vs_baseline" not in line and "error" not in line
    assert line["upload_excluded"] is False
    assert line["device"] == "cpu" and line["batch"] == 2
    assert line["rpn"] == "reference" and line["image_min_side"] == 0
    if not flags:
        assert line["raw_forward_fps"] > 0
        assert line["host_feed_ms_per_batch"] > 0
        assert line["serve_loop_ms_per_batch"] > 0


def test_a_failing_child_exits_nonzero(tiny_yaml):
    rc, line, err = _bench("--config", tiny_yaml, "--device", "cpu",
                           "--iters", "1", "--warmup", "0",
                           "--rpn", "no-such-trunk")
    assert rc != 0
    assert line["value"] == 0.0 and "rc=1" in line["error"]
    assert "unknown RPN trunk" in err


def test_train_under_batch_scope_prints_one_json_line(tiny_yaml):
    """``--train --norm-scope batch``: JAX's A/B of the norms' scope."""
    rc, line, err = _bench("--config", tiny_yaml, "--device", "cpu",
                           "--iters", "2", "--warmup", "1", "--train",
                           "--norm-scope", "batch")
    assert rc == 0, err[-2000:]
    assert line["metric"] == _root_metric_name(train=True)
    assert line["value"] > 0 and line["norm_scope"] == "batch"


def test_defaults_are_the_reference_model():
    args = bench.parse_args([])
    cfg = bench.bench_config(args)
    assert cfg.image_min_side == 800.0
    assert cfg.rpn_trunk == REFERENCE_RPN_TRUNK
    assert cfg.use_bf16 and cfg.batch_size == 8
    assert args.device == "cuda"
    econ = bench.bench_config(bench.parse_args(
        ["--config", os.path.join(ROOT, "configs", "serving_economy.yaml")]))
    assert econ.image_min_side == 400.0 and econ.rpn_channels == (64, 64, 128)
    over = bench.bench_config(bench.parse_args(
        ["--rpn", "half", "--image-min-side", "0", "--batch", "2"]))
    assert (over.rpn_channels, over.image_min_side, over.batch_size) == (
        (64, 64, 128), 0.0, 2)


@pytest.mark.parametrize("flags,item", [
    (["--gather-backend", "raw4"], "gather-backend"),
    (["--fusion-stats", "full"], "fusion-stats")])
def test_flags_without_a_formulation_are_refused(flags, item, capsys):
    """JAX's layout flags are refused with the reason: the port computes
    the one function they all compute."""
    with pytest.raises(SystemExit) as e:
        bench.parse_args(flags)
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert item in err and "one function" in err and "K2" in err
    assert "ROADMAP" not in err


@pytest.mark.parametrize("scope", ["sample", "batch"])
def test_norm_scope_reaches_the_config(scope):
    """``--norm-scope`` sets ``Config.norm_scope``, as JAX's bench.py
    does; without it the Config's default (or the --config file's)
    stays."""
    cfg = bench.bench_config(bench.parse_args(["--norm-scope", scope]))
    assert cfg.norm_scope == scope
    assert bench.bench_config(bench.parse_args([])).norm_scope == "sample"
    econ = bench.bench_config(bench.parse_args(
        ["--config", os.path.join(ROOT, "configs", "serving_economy.yaml"),
         "--norm-scope", scope]))
    assert econ.norm_scope == scope and econ.image_min_side == 400.0


# -- the supervisor and the stage watchdog (the port's copy) --------------

def _child(body: str) -> list:
    return [sys.executable, "-c", textwrap.dedent(body)]


def test_supervisor_salvages_partial_on_stall():
    rec = supervise(_child("""
        import json, os, time
        with open(os.environ["BENCH_PARTIALS"], "a") as f:
            f.write(json.dumps({"metric": "raw", "value": 68.7,
                                "unit": "frames/s"}) + "\\n")
        time.sleep(60)
    """), metric="e2e", attempt_timeout=5, retries=1)
    assert rec["value"] == 68.7
    assert rec["partial"] is True
    assert "timeout" in rec["error"]


def test_supervisor_retry_recovers_transient_failure(tmp_path):
    flag = tmp_path / "attempted_once"
    rec = supervise(_child(f"""
        import json, os, sys
        flag = {str(flag)!r}
        if not os.path.exists(flag):
            open(flag, "w").close()
            print(json.dumps({{"metric": "e2e", "value": 0.0,
                               "error": "watchdog: stage 'serve'"}}))
            sys.exit(2)
        print(json.dumps({{"metric": "e2e", "value": 66.9,
                           "unit": "frames/s"}}))
    """), metric="e2e", attempt_timeout=30, retries=1)
    assert rec["value"] == 66.9
    assert rec["retried"] == 1
    assert "error" not in rec


def test_supervisor_error_record_when_nothing_salvageable():
    rec = supervise(_child("import sys; sys.exit(3)"),
                    metric="e2e", attempt_timeout=10, retries=1)
    assert rec["value"] == 0.0
    assert "rc=3" in rec["error"]
    assert "vs_baseline" not in rec


def test_stage_watchdog_names_the_wedged_stage(capsys):
    wd = StageWatchdog({"raw_warmup": 30, "serve_warmup": 1}, metric="e2e")
    try:
        wd.enter("serve_warmup")
        with pytest.raises(StageStall):
            time.sleep(5)
    finally:
        wd.cancel()
        signal.signal(signal.SIGALRM, signal.SIG_DFL)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["stage"] == "serve_warmup"
    assert "serve_warmup" in rec["error"]
    assert rec["value"] == 0.0


def test_force_stall_injection_hook():
    proc = subprocess.run(_child("""
        from mvxnet_makise_tpu_torch.utils.watchdog import StageWatchdog
        wd = StageWatchdog({"raw_measure": 1}, metric="e2e")
        wd.enter("raw_measure")
        print("unreachable")
    """), env=dict(os.environ, BENCH_FORCE_STALL="raw_measure"),
        capture_output=True, text=True, timeout=30, cwd=ROOT)
    assert proc.returncode == 2
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["stage"] == "raw_measure"
    assert "unreachable" not in proc.stdout


def test_partial_writer_noop_without_path(tmp_path):
    PartialWriter(None).emit({"x": 1})
    p = tmp_path / "p.jsonl"
    w = PartialWriter(str(p))
    w.emit({"value": 1.0})
    w.emit({"value": 2.0})
    lines = [json.loads(s) for s in p.read_text().splitlines()]
    assert [r["value"] for r in lines] == [1.0, 2.0]
