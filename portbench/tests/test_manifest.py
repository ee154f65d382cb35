"""BENCHMARK.json against the benchmark's contract, and every piece it
names found under ``portbench/`` by that name."""

import json
import os
import re

from portbench.lib import registry
from portbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)|(_dim|_rank)$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    # a full check of 24 cells fits the check's time
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(b["configs"]) <= 24 and 1 <= cells <= 24
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)


def test_configs():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["name"] in used
        assert c["file"] == "portbench/configs/%s.json" % c["name"]
        on_disk = registry.load_json("configs", c["name"])
        assert on_disk["source"] == c["source"] and on_disk["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])


def test_cells():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    seen = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        spec = registry.cell(w["name"])
        assert (spec["cell"]["config"], spec["cell"]["traffic"]) == (w["config"], w["traffic"])
        assert spec["driver"] is not None


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert registry.load_module("metrics", m["name"]) is not None, m["name"]
        assert set(m.get("workloads", [])) <= cells
    for cell in cells:
        reported = registry.metrics_of(b, cell, False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert registry.metrics_of(b, cell, True)
