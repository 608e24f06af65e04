"""BENCHMARK.json against the contract: every entry resolves to its files
by name, and names, units and keys use what is allowed."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["perfbench"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_configs_resolve(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]


def test_workloads_resolve(bench):
    names = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "limits", w["name"] + ".json"))
        assert 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_resolve(bench, kind):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e and m["workloads"]
            assert os.path.exists(os.path.join(
                ROOT, "perfbench", "metrics", m["name"] + ".py"))
    if kind == "end_to_end":
        assert "setup_s" in e2e


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in bench["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in bench["per_layer"] if has(m)]
        assert layer
        assert all(m["moves"] in e2e for m in layer)
