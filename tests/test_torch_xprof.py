"""The port's profiler harness (``obs/xprof.py``, over ``torch.profiler``)
against the JAX package's: the trace digestion (``load_trace_events`` on
gzipped, plain and bare-list traces, ``op_table``, ``match_budget_entry``,
``render_table``) must give equal results on the same inputs; a CPU
capture of a port window must give an ``ok`` row that passes the schema
gate; a failing profiler must give an ``ok=False`` row, never an
exception.  Tolerance: none.
"""

from __future__ import annotations

import gzip
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from ringpop_tpu.obs import xprof as jx
from ringpop_tpu.obs.recorder import read_run_log as jax_read_run_log
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.obs import xprof as px
from ringpop_tpu_torch.obs.recorder import RunRecorder
from ringpop_tpu_torch.ops import toolkit
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EVENTS = [
    {"ph": "X", "name": "fusion.exchange", "dur": 40.0, "ts": 0},
    {"ph": "X", "name": "fusion.exchange", "dur": 10.0, "ts": 1},
    {"ph": "X", "name": "all-to-all", "dur": 30.0, "ts": 2},
    {"ph": "X", "name": "copy", "dur": 5.0, "ts": 3},
    {"ph": "X", "name": "zero-dur-marker", "dur": 0, "ts": 4},
    {"ph": "M", "name": "process_name", "args": {}},
]

KERNEL_NAMES = [
    "apply_updates_kernel(ApplyArgs, int, int, int, int)",
    "pb_budget_kernel(unsigned char const*, int const*, int, int)",
    "fused_stream_kernel(unsigned int const*, unsigned int const*, int)",
    "block_loop_kernel(unsigned int const*, unsigned int const*, int)",
    "exchange_kernel(unsigned int const*, unsigned int const*, int, int)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>>(int)",
    "Memset (Device)",
    "aten::index_put_",
]


def _write(path, events, bare=False):
    raw = json.dumps(events if bare else {"traceEvents": events}).encode()
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(raw)


def _events(seed, count=300):
    rng = np.random.default_rng(seed)
    names = KERNEL_NAMES + ["fusion.%d" % i for i in range(6)]
    out = []
    for i in range(count):
        ev = {"ph": str(rng.choice(["X", "X", "X", "i", "M"])), "name": str(rng.choice(names)),
              "ts": i, "dur": float(rng.choice([0.0, -1.0, 0.5, 3.25, 17.0, 120.125]))}
        if rng.random() < 0.05:
            ev["dur"] = "bad"
        out.append(ev)
    return out


def test_load_trace_events_equal_jax(tmp_path):
    gz = tmp_path / "plugins" / "profile" / "run1" / "t.trace.json.gz"
    gz.parent.mkdir(parents=True)
    _write(gz, EVENTS)
    plain = tmp_path / "port" / "w.trace.json"
    plain.parent.mkdir()
    _write(plain, _events(1))
    bare = tmp_path / "bare.trace.json"
    _write(bare, EVENTS, bare=True)
    for path in (gz, plain, bare):
        assert px.load_trace_events(str(path)) == jx.load_trace_events(str(path))
    assert px.load_trace_events(str(bare)) == EVENTS
    os.utime(gz, (1, 1))
    # the port's discovery takes the profiler's plain form too, newest first
    assert jx.find_trace_files(str(tmp_path)) == [str(gz)]
    assert set(px.find_trace_files(str(tmp_path))) == {str(gz), str(plain), str(bare)}
    assert px.find_trace_files(str(tmp_path))[-1] == str(gz)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("top_k", [0, 3, 10, 100])
def test_op_table_equal_jax(seed, top_k):
    events = EVENTS if seed == 0 else _events(seed)
    for entries in (None, [], sorted(t.kernel_entry for t in toolkit.TWIN_REGISTRY),
                    ["exchange-plane", "engine-scalable-tick"]):
        assert (px.op_table(events, top_k=top_k, budget_entries=entries)
                == jx.op_table(events, top_k=top_k, budget_entries=entries))


def test_match_budget_entry_equal_jax_and_keys_the_kernels():
    entries = px._budget_entry_names()
    assert entries == sorted(t.kernel_entry for t in toolkit.TWIN_REGISTRY)
    for name in KERNEL_NAMES + ["fusion.exchange_plane.1", "scalable_tick_scan", "", "%%"]:
        for e in (entries, ["exchange-plane", "engine-scalable-tick"], None):
            assert px.match_budget_entry(name, e) == jx.match_budget_entry(name, e)
    # every CUDA kernel symbol in csrc/ keys to its own wrapper's name
    for twin in toolkit.TWIN_REGISTRY:
        with open(os.path.join(REPO_ROOT, twin.source)) as fh:
            symbols = re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", fh.read())
        assert symbols, twin.source
        for sym in symbols:
            assert px.match_budget_entry("%s(int, int)" % sym, entries) == twin.kernel_entry, sym
    assert px.match_budget_entry("aten::index_put_", entries) is None


def test_render_table_equal_jax():
    ops, total = px.op_table(_events(4), top_k=5, budget_entries=px._budget_entry_names())
    row = {"phase": "w", "ok": True, "wall_s": 0.1, "trace_dir": "/x", "num_trace_files": 1,
           "total_self_us": total, "ops": ops}
    assert px.render_table(row) == jx.render_table(row)
    bad = dict(row, ok=False, error="profiler capture failed: x", ops=[])
    assert px.render_table(bad) == jx.render_table(bad)
    noted = dict(row, note="torch.profiler delivered no device record")
    assert px.render_table(noted).splitlines()[1] == "  note: " + noted["note"]


def test_digest_prefers_device_records_on_a_card():
    cpu = [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 5.0}]
    dev = [{"ph": "X", "cat": "kernel", "name": KERNEL_NAMES[0], "dur": 2.0},
           {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 1.0},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 4.0}]
    row = {}
    assert px._digest(cpu + dev, True, row) == dev[:2]
    assert row == {"kernel_records": 1, "digest": "device"}
    row = {}
    assert px._digest(cpu + dev[2:], True, row) == cpu
    assert row["digest"] == "cpu_op" and row["kernel_records"] == 0 and "no device record" in row["note"]
    row = {}
    assert px._digest(cpu + dev, False, row) == cpu
    assert row == {"kernel_records": 1, "digest": "cpu_op"}


def _checker():
    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema", os.path.join(REPO_ROOT, "scripts", "check_metrics_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _window():
    sim = SimCluster(n=16, params=pe.SimParams(n=16, checksum_mode="fast"), device="cpu")
    sim.bootstrap()
    return lambda: sim.run(EventSchedule.churn_window(4, 16))


def test_cpu_capture_of_a_port_window(tmp_path):
    run = _window()
    path = str(tmp_path / "xprof.runlog.jsonl")
    with RunRecorder(path, config={}) as rec:
        row = px.capture(run, str(tmp_path / "trace"), phase="unit", warmup=1, repeats=2,
                         recorder=rec)
    assert row["ok"], row.get("error")
    assert row["num_trace_files"] == 1 and os.path.exists(tmp_path / "trace" / "unit.trace.json")
    assert row["wall_s"] > 0 and row["total_self_us"] > 0 and row["ops"]
    assert row["digest"] == "cpu_op" and row["kernel_records"] == 0
    assert all(op["name"].startswith("aten::") for op in row["ops"])
    assert len(row["ops"]) == px.DEFAULT_TOP_K
    assert px.XPROF_FIELDS == jx.XPROF_FIELDS and px.XPROF_EVENT == jx.XPROF_EVENT
    assert _checker().check([path], verbose=False) == []
    (ev,) = [e for e in jax_read_run_log(path)["events"] if e["name"] == "xprof.capture"]
    assert ev["ops"] == row["ops"] and ev["phase"] == "unit"
    assert "xprof[unit]: ok=True" in px.render_table(row)


def test_capture_failures_are_rows(tmp_path, monkeypatch):
    run = _window()

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    calls = []
    row = px.capture(lambda: calls.append(1) or run(), str(tmp_path / "a"), phase="unit",
                     warmup=2)
    assert row["ok"] is False and "profiler capture failed: no profiler here" in row["error"]
    assert len(calls) == 2 and row["wall_s"] is None
    assert "error" in px.render_table(row)
    monkeypatch.undo()
    monkeypatch.setattr(px, "find_trace_files", lambda d: [])
    row = px.capture(run, str(tmp_path / "b"), phase="unit", warmup=0)
    assert row["ok"] is False and "no trace files" in row["error"] and row["wall_s"] > 0
    monkeypatch.setattr(px, "find_trace_files", lambda d: [str(tmp_path / "missing.trace.json")])
    row = px.capture(run, str(tmp_path / "c"), phase="unit", warmup=0)
    assert row["ok"] is False and row["error"].startswith("trace parse failed")
    for field in px.XPROF_FIELDS:
        assert field in row
