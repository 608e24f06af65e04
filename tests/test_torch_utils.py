"""PyTorch port: ``utils/logging.MetricsLogger`` and
``utils/profiling.trace_context`` against the JAX package's.

The same calls give the same JSONL records (apart from ``time``, the
seconds since the logger was made) and the same console lines; a trace
of the port's is a Chrome trace that names the operations run inside it,
and a disabled one writes nothing.
"""

import json
import os

import numpy as np
import torch

from mvxnet_makise_tpu.utils.logging import MetricsLogger as JaxLogger
from mvxnet_makise_tpu_torch.utils.logging import MetricsLogger
from mvxnet_makise_tpu_torch.utils.profiling import trace_context

CALLS = [
    (0, {"loss": 1.25, "num_pos": np.int32(3)}, {}),
    (1, {"loss": np.float32(0.5), "cls": torch.tensor(0.25)},
     {"lr": 1e-3, "phase": "train"}),
    (2, {"ap": {"Car": 0.5}, "skipped": True}, {"note": None}),
]


def _run(cls, path, capsys):
    recs = []
    with cls(path) as log:
        for step, metrics, extra in CALLS:
            recs.append(log.log(step, metrics, **extra))
    return recs, capsys.readouterr().out


def _without_time(rec):
    return {k: v for k, v in rec.items() if k != "time"}


def test_metrics_logger_matches_jax(tmp_path, capsys):
    port, port_out = _run(MetricsLogger, str(tmp_path / "port" / "m.jsonl"),
                          capsys)
    jax_recs, jax_out = _run(JaxLogger, str(tmp_path / "jax" / "m.jsonl"),
                             capsys)
    assert [_without_time(r) for r in port] == [_without_time(r)
                                                for r in jax_recs]
    assert port_out == jax_out and port_out.count("\n") == len(CALLS)
    files = {}
    for name in ("port", "jax"):
        with open(tmp_path / name / "m.jsonl") as f:
            files[name] = [_without_time(json.loads(ln)) for ln in f]
    assert files["port"] == files["jax"] and len(files["port"]) == 3
    assert all(isinstance(r["time"], float) for r in port)


def test_metrics_logger_without_a_file_echoes_only(capsys, tmp_path):
    log = MetricsLogger(None, echo=True)
    rec = log.log(7, {"loss": 2.0})
    log.close()
    assert rec["step"] == 7 and rec["loss"] == 2.0
    assert capsys.readouterr().out == "step=7 loss=2.00000\n"
    quiet = MetricsLogger(str(tmp_path / "q.jsonl"), echo=False)
    quiet.log(1, {"x": 1})
    quiet.close()
    assert capsys.readouterr().out == ""
    assert os.path.getsize(tmp_path / "q.jsonl") > 0


def test_trace_context_writes_a_trace_that_names_the_ops(tmp_path):
    a = torch.randn(64, 64)
    with trace_context(str(tmp_path / "trace")):
        torch.mm(a, a).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


def test_trace_context_disabled_traces_nothing(tmp_path):
    with trace_context(str(tmp_path / "off"), enabled=False):
        torch.ones(2).sum()
    assert not os.path.exists(tmp_path / "off")
