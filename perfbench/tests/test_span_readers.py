"""The readers of the program's ``mvx.*`` spans on hand-made traced
windows: each new reader's value, None where the program has no spans
(as before the spans existed), and every other reader's value unchanged
by the spans' events and by what the new readers leave in the context."""

import json
import os

import pytest

from perfbench import run, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
SPAN_READERS = {
    "feed_wait_ms.serve", "image_ms.serve", "vfe_ms.serve", "cml_ms.serve",
    "rpn_ms.serve", "decode_ms.serve", "forward_ms.train",
    "backward_ms.train", "optimizer_ms.train", "backward_launches.train",
    "sync_wait_ms.stream", "host_syncs_per_frame.stream"}
OTHERS = sorted(m["name"] for m in BENCH["per_layer"]
                if m["name"] not in SPAN_READERS)

# serving: two batches of 1 s; every span of batch b at b + its offset
SERVE_SPANS = {"mvx.serve.upload": (0.00, 0.10),
               "mvx.model.image": (0.10, 0.20),
               "mvx.model.vfe": (0.20, 0.30),
               "mvx.model.cml": (0.30, 0.40),
               "mvx.model.rpn": (0.40, 0.50),
               "mvx.serve.decode": (0.50, 0.60)}
# (launch kind, launch offset, device ms) of each batch's operations; the
# card runs them 0.05 s after their launch, in launch order per kind
SERVE_OPS = [("memcpy", 0.05, 2.0), ("kernel", 0.15, 7.0),
             ("memset", 0.16, 0.5), ("kernel", 0.17, 3.0),
             ("kernel", 0.25, 4.0), ("kernel", 0.35, 5.0),
             ("kernel", 0.45, 6.0), ("kernel", 0.55, 1.5),
             ("kernel", 0.58, 0.25)]
LAUNCH = {"kernel": "cudaLaunchKernel", "memcpy": "cudaMemcpyAsync",
          "memset": "cudaMemsetAsync"}
DEVICE = {"kernel": "void conv_kernel<float>", "memcpy": "Memcpy HtoD",
          "memset": "Memset (Device)"}


def _window(host, device):
    """The context ``run.layer_context`` gives the readers, from the
    reduced events, with the benchmark's own numbers fixed."""
    ev = {"device": device,
          "kernels": [d for d in device
                      if not d[0].startswith(("Memcpy", "Memset"))],
          "spans": {"perfbench.batch": [(0.0, 1.0), (1.0, 2.0)],
                    "perfbench.frame": [(0.0, 1.0), (1.0, 2.0)],
                    "perfbench.step": [(0.0, 1.0), (1.0, 2.0)]},
          "host": host}
    merged = trace.union([(s, e) for _, s, e in device])
    return {"cell": "hand", "events": ev, "lo": 0.0, "hi": 2.0,
            "window_s": 2.0, "busy_s": trace.covered(merged, 0.0, 2.0),
            "merged": merged, "frames": 2, "steps": 2, "flops": 1e12,
            "peaks": {}, "peak_flop_per_s": 67e12, "k1_bound_s": 1e-3,
            "k1_bwd_bound_s": 2e-3, "k2_bound_s": 5e-4,
            "host_feed_ms": [8.0, 9.0],
            "ranks": [{"steps": 2, "kernels": 9, "nccl_s_per_step": 0.1,
                       "window_s": 2.0, "busy_s": 1.0, "work_s": 0.8}]}


def _ops(ops, spans, program=True, syncs=((0.7, 0.9),)):
    """Two units (batches, steps) of ``ops`` under ``spans``; ``syncs``:
    the host's waits for the card in each."""
    host, device, clock = [], [], {k: 0.0 for k in LAUNCH}
    for b in range(2):
        if program:
            host.append(("mvx.serve.batch", b, b + 1.0))
            # the first wait is the pipeline's fill, which is left out
            host.append(("mvx.serve.feed_wait", b - (0.05 if b == 0
                                                     else 0.01), b))
            for name, (s, e) in spans.items():
                host.append((name, b + s, b + e))
        for kind, t, ms in ops:
            host.append((LAUNCH[kind], b + t, b + t + 1e-5))
            # device operations of a kind start in the order launched
            start = max(b + t + 0.05, clock[kind])
            device.append((DEVICE[kind], start, start + ms * 1e-3))
            clock[kind] = start + ms * 1e-3
        # a wait for the card returns once what ran before it is done
        for s, e in syncs:
            host.append(("cudaStreamSynchronize", b + s, b + e))
    host.append(("aten::conv2d", 0.1, 0.11))
    return host, device


def _read(name, ctx):
    return run.read_metric(name, ctx)


def test_serving_readers():
    ctx = _window(*_ops(SERVE_OPS, SERVE_SPANS))
    want = {"image_ms.serve": 7.0 + 0.5 + 3.0, "vfe_ms.serve": 4.0,
            "cml_ms.serve": 5.0, "rpn_ms.serve": 6.0,
            "decode_ms.serve": 1.75, "feed_wait_ms.serve": 10.0}
    for name, v in want.items():
        assert _read(name, ctx) == pytest.approx(v, rel=1e-9), name


def test_feed_wait_leaves_out_the_pipeline_fill():
    host, device = _ops(SERVE_OPS, SERVE_SPANS)
    fill = [h for h in host if h[0] == "mvx.serve.feed_wait"][0]
    assert fill[2] - fill[1] == pytest.approx(0.05)
    only_fill = [h for h in host
                 if h[0] != "mvx.serve.feed_wait" or h is fill]
    assert _read("feed_wait_ms.serve", _window(only_fill, device)) is None


def test_training_readers():
    spans = {"mvx.train.step": (0.0, 0.9), "mvx.train.forward": (0.1, 0.2),
             "mvx.train.backward": (0.2, 0.5),
             "mvx.train.optimizer": (0.6, 0.7)}
    ops = [("kernel", 0.05, 1.0), ("kernel", 0.15, 2.0),
           ("memcpy", 0.18, 0.5), ("kernel", 0.25, 3.0),
           ("kernel", 0.30, 4.0), ("memset", 0.40, 0.25),
           ("kernel", 0.45, 5.0), ("kernel", 0.65, 6.0)]
    host, device = _ops(ops, spans)
    host = [h for h in host if not h[0].startswith("mvx.serve")]
    ctx = _window(host, device)
    assert _read("forward_ms.train", ctx) == pytest.approx(2.5)
    assert _read("backward_ms.train", ctx) == pytest.approx(12.25)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(6.0)
    assert _read("backward_launches.train", ctx) == 3


def test_launches_without_device_records_at_the_window_start():
    """The profiler drops the device records of a window's first few
    operations and keeps their launches: the pairs, counted from the
    window's end, stay right."""
    spans = {"mvx.train.step": (0.0, 0.9), "mvx.train.backward": (0.2, 0.5),
             "mvx.train.optimizer": (0.75, 0.8)}
    ops = [("kernel", 0.25, 3.0), ("kernel", 0.30, 4.0),
           ("kernel", 0.76, 6.0), ("kernel", 0.77, 2.0),
           ("memcpy", 0.78, 1.0)]
    host, device = _ops(ops, spans, syncs=((0.55, 0.6),))
    host = [h for h in host if not h[0].startswith("mvx.serve")]
    host += [("cudaLaunchKernel", 0.01, 0.01001),
             ("cudaLaunchKernel", 0.02, 0.02001),
             ("cudaMemcpyAsync", 0.03, 0.03001)]
    ctx = _window(host, device)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(9.0)
    assert _read("backward_ms.train", ctx) == pytest.approx(7.0)
    assert _read("backward_launches.train", ctx) == 2


def test_a_card_clock_off_the_hosts_pairs_in_order():
    """Device times 0.2 s late against the host's: the pairs, by order,
    need no clock the two share."""
    host, device = _ops(SERVE_OPS, SERVE_SPANS)
    late = [(n, s + 0.2, e + 0.2) for n, s, e in device]
    for shifted in (device, late):
        ctx = _window(host, shifted)
        assert _read("decode_ms.serve", ctx) == pytest.approx(1.75)
        assert _read("image_ms.serve", ctx) == pytest.approx(10.5)


def test_sensor_readers():
    host, device = _ops(SERVE_OPS, SERVE_SPANS)
    host += [("mvx.sync", 0.70, 0.702), ("mvx.sync", 0.80, 0.801),
             ("mvx.sync", 1.70, 1.703)]
    ctx = _window(host, device)
    assert _read("host_syncs_per_frame.stream", ctx) == 1.5
    assert _read("sync_wait_ms.stream", ctx) == pytest.approx(3.0)


def test_span_readers_read_nothing_without_the_programs_spans():
    ctx = _window(*_ops(SERVE_OPS, SERVE_SPANS, program=False))
    for name in sorted(SPAN_READERS):
        assert _read(name, ctx) is None, name


def test_other_readers_unchanged_by_the_spans():
    plain = _window(*_ops(SERVE_OPS, SERVE_SPANS, program=False))
    spanned = _window(*_ops(SERVE_OPS, SERVE_SPANS))
    spanned["events"]["host"] += [("mvx.sync", 0.7, 0.71),
                                  ("mvx.train.step", 0.0, 0.9)]
    for name in sorted(SPAN_READERS):
        _read(name, spanned)
    assert "_launched" in spanned
    for name in OTHERS:
        a, b = _read(name, plain), _read(name, spanned)
        assert a == b, name
    assert OTHERS and len(OTHERS) + len(SPAN_READERS) == len(
        BENCH["per_layer"])
