"""PyTorch port: ``tools/multicard.py``, the mesh checks of the four-card
run, on the CPU.

``--device cpu`` starts two gloo ranks through ``torch.distributed.run``
(a (2, 1) mesh) at ``tests/test_torch_parallel.py``'s tiny configuration
in float64; each rank's serving maps and one train step must equal the
single-process port (the same rows, and the whole batch) to 1e-10.  No
JAX train step is compiled here: the mesh path's parity with JAX stays
with ``tests/test_torch_parallel.py``.  With fewer cards than asked the
command raises before it starts a rank.
"""

import json
import subprocess

import pytest
import torch

from mvxnet_makise_tpu_torch.tools import multicard

TOL = 1e-10


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("multicard") / "records.json"
    code = multicard.main(["--cards", "2", "--device", "cpu",
                           "--out", str(out)])
    return code, json.loads(out.read_text())


def test_cpu_mode_runs_two_gloo_ranks(cpu_run):
    code, records = cpu_run
    assert code == 0
    assert set(records) == set(multicard.CPU_PLAN.checks)
    for rec in records.values():
        assert rec["ok"] and len(rec["ranks"]) == 2
    init = records["init"]["ranks"]
    assert [r["backend"] for r in init] == ["gloo", "gloo"]
    assert [r["primary"] for r in init] == [True, False]


def test_mesh_serving_equals_single_process(cpu_run):
    """Each rank's maps are bit-equal to the single-process port's on its
    rows and within 1e-10 of its run of the whole batch; every rank's
    gathered detections equal the single-process runs, frame by
    frame."""
    _, records = cpu_run
    for r in records["serve_data"]["ranks"]:
        assert r["mesh"] == [2, 1]
        assert r["maps_bit_equal_meshless_same_rows"]
        assert r["maps_vs_meshless_whole_batch"] <= TOL
        assert r["detections_equal_meshless_same_rows"]
        assert r["stream_equal_meshless_same_rows"]
        assert len(r["detections_per_frame"]) == multicard.CPU_PLAN.frames
        assert sum(r["detections_per_frame"]) > 0


def test_mesh_step_equals_single_process(cpu_run):
    """One mesh step: loss, metrics and every gradient within 1e-10 of the
    single-process step on the whole batch and of the same step run shard
    by shard and averaged; the parameters after the update within AdamW's
    bound."""
    _, records = cpu_run
    for r in records["steps"]["ranks"]:
        step = r["steps"]["2x1 sample"]
        whole, by_shard = step["vs_one_card_whole_batch"], \
            step["vs_one_card_by_shard"]
        assert whole["same_keys"] and by_shard["same_keys"]
        for d in (whole, by_shard):
            assert d["metrics"] <= TOL and d["grads"] <= TOL
        assert whole["params_within_update_bound"]
        assert abs(step["loss"] - step["loss_one_card"]) <= TOL


def test_fewer_cards_than_asked_starts_nothing(monkeypatch):
    """Four cards asked where there are two (or none): the command raises
    before it starts any rank; it never runs fewer ranks or gloo."""
    def refuse(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(subprocess, "run", refuse)
    with pytest.raises(SystemExit, match="4 cards asked, 0 found"):
        multicard.main(["--cards", "4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="4 cards asked, 2 found"):
        multicard.main(["--cards", "4"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_nudge_moves_each_value_one_ulp(dtype):
    x = torch.tensor([0.3, 1.0, -2.5, 1e-3], dtype=torch.float32)
    y = multicard.nudge(x, dtype)
    assert y.dtype == torch.promote_types(torch.float32, dtype)
    step = (x.to(dtype).abs() * torch.finfo(dtype).eps).to(y.dtype)
    d = (y - x.to(dtype).to(y.dtype)).abs()
    assert bool((d > 0).all()) and bool((d <= step).all())


def test_update_bound_holds_for_adamw_and_catches_a_lost_update():
    """Two AdamW first steps from the same parameters with gradients a
    little apart stay within the bound; an update applied twice or not
    at all does not."""
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(1000, generator=gen)
    g = torch.randn(1000, generator=gen) * torch.logspace(-9, 0, 1000)
    g2 = g + torch.randn(1000, generator=gen) * 1e-8
    lr, eps = 1e-3, 1e-6

    def step(grad):
        p = torch.nn.Parameter(p0.clone())
        opt = torch.optim.AdamW([p], lr=lr, eps=eps, weight_decay=1e-4)
        p.grad = grad.clone()
        opt.step()
        return p.detach()

    a, b = step(g), step(g2)
    assert multicard.update_bound(a, b, g, g2, lr, eps)[0]
    assert not multicard.update_bound(p0, b, g, g2, lr, eps)[0]
    twice = b - (p0 - b)
    assert not multicard.update_bound(twice, b, g, g2, lr, eps)[0]


def test_device_window_counts_kernels_not_annotations():
    """Busy time is the union of the kernels' intervals; NCCL's kernels
    count toward it and toward the NCCL ms, the ``nccl:all_reduce`` range
    the profiler mirrors onto the device timeline toward neither, and
    host events toward nothing."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    def ev(name, start, end, device=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=Interval(start, end),
                               is_user_annotation=annotation)

    prof = SimpleNamespace(events=lambda: [
        ev("gemm", 0, 1000), ev("relu", 500, 1500),
        ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 3000, 4000),
        ev("nccl:all_reduce", 2900, 4100, annotation=True),
        ev("aten::mm", 0, 9000, device=DeviceType.CPU)])
    w = multicard.device_window(prof, wall_ms=10.0)
    assert w["device_busy_ms"] == 2.5 and w["compute_busy_ms"] == 1.5
    assert w["nccl_device_ms"] == 1.0
    assert w["device_idle_share"] == 0.75
