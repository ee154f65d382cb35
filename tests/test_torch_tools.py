"""The port's operator tools (``ringpop_tpu_torch/tools/`` and the traffic
gate in ``analysis/traffic.py``) on the CPU, each against its JAX
counterpart's output or the committed JAX artifact.  Tolerance: none.

- ``export_parity_replay`` at its defaults, ``--fused`` and
  ``--no-fused``: every snapshot equals the committed
  ``PARITY_REPLAY.json``'s.
- ``export_parity_trajectory -n 64 --ticks 42``: equal to the JAX
  script's artifact of the same arguments (made here in a subprocess) in
  every field but ``generator``.
- ``export_flight_trace``: its sidecar and dissemination summary equal the
  committed ``runlogs/sample_flight_n64`` ones.  ``export_request_trace``:
  its sidecar equals the JAX script's, run here on a copy of the script
  that writes into a temporary folder.  (The committed
  ``runlogs/sample_requests_n64`` sidecar was made with JAX's legacy
  threefry, ``jax_threefry_partitionable=False``; the port follows the
  partitionable threefry that this JAX version runs by default, as the
  JAX script does here.)  Both run logs pass both packages' schema checks.
- ``fuzz_sweep replay`` on both committed fixtures: JAX's lines and exit
  code.  ``check_ckpt_manifest`` and ``check_metrics_schema``: JAX's
  verdicts on the committed sample checkpoint, a byte-flipped copy, every
  committed run log and sidecar, and a broken log.
- The traffic gate: the port's manifest holds the JAX
  ``TRAFFIC_BUDGET.json``'s numbers, every entry measured on the CPU
  matches it, and a doctored manifest or failed entry is refused.
- ``sharded_app``: every key is answered by its ring owner.
- The device rule: the tools that run tensors (the exporters,
  ``fuzz_sweep`` and the traffic prong) raise without a card unless
  ``--device cpu`` is passed; the host-only tools need no card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ringpop_tpu_torch.analysis import __main__ as analysis_cli
from ringpop_tpu_torch.analysis import traffic
from ringpop_tpu_torch.models.route.plane import RouteMetrics
from ringpop_tpu_torch.obs import requests as poreq
from ringpop_tpu_torch.obs import slo as pslo
from ringpop_tpu_torch.tools import (check_ckpt_manifest, check_metrics_schema,
                                     export_flight_trace, export_parity_replay,
                                     export_parity_trajectory, export_request_trace, fuzz_sweep,
                                     sharded_app)

REPO_ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = REPO_ROOT / "scripts"
RUNLOGS = REPO_ROOT / "runlogs"
FIXTURES = sorted(str(p) for p in (REPO_ROOT / "tests" / "fuzz" / "fixtures").glob("*.json"))
SAMPLE_CKPT = RUNLOGS / "sample_ckpt_scalable_n8"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location("jax_" + name, SCRIPTS / ("%s.py" % name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(args, cwd=None):
    """A JAX script in its own process on the CPU (it pins its platform),
    as a user runs it: without the ``RINGPOP_*`` switches that an earlier
    test's import may have left in this process's environment
    (``ringpop_tpu.api.cli`` sets ``RINGPOP_TPU_NO_X64``, under which the
    exporters overflow int32)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("RINGPOP_")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO_ROOT))
    return subprocess.run([sys.executable] + [str(a) for a in args], env=env, cwd=cwd or REPO_ROOT,
                          capture_output=True, text=True, timeout=600)


def _load(path):
    with open(path) as f:
        return json.load(f)


# -- the Node-parity artifacts -----------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_parity_replay_equals_committed_artifact(fused, tmp_path, capsys):
    out = tmp_path / "replay.json"
    argv = ["--device", "cpu", "-o", str(out)] + ([] if fused else ["--no-fused"])
    assert export_parity_replay.main(argv) == 0
    assert json.loads(capsys.readouterr().out)["snapshots"] == 13
    got, want = _load(out), _load(REPO_ROOT / "PARITY_REPLAY.json")
    assert len(got["snapshots"]) == len(want["snapshots"])
    for a, b in zip(got["snapshots"], want["snapshots"]):
        assert a == b, (a["tick"], a["observer"])
    for key in set(want) - {"generator", "engine"}:
        assert got[key] == want[key], key
    assert got["generator"] == export_parity_replay.GENERATOR
    assert ("fused record-cache" in got["engine"]) is fused


def test_parity_replay_refuses_a_short_run():
    with pytest.raises(SystemExit):
        export_parity_replay.main(["--device", "cpu", "--ticks", "20"])


def test_parity_trajectory_equals_jax_script(tmp_path, capsys):
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    proc = _run_jax([SCRIPTS / "export_parity_trajectory.py", "-n", "64", "--ticks", "42", "-o",
                     theirs])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert export_parity_trajectory.main(["-n", "64", "--ticks", "42", "-o", str(mine),
                                          "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    got, want = _load(mine), _load(theirs)
    assert set(got) == set(want)
    for key in set(want) - {"generator"}:
        assert got[key] == want[key], key
    assert got["ticks_data"][-1]["distinct_checksums"] == 1
    assert line["unrepresented_total"] == want["unrepresented_group_nodes_total"]
    assert {"engine_s", "read_s", "host_s"} <= set(line)


def test_committed_trajectory_checksums_rederive_with_native_farmhash():
    """The check ``validate_trajectory.js`` makes, with the port's C++
    FarmHash: what the card's artifact is held to in ``chip_smoke.py``."""
    from ringpop_tpu_torch.ops import native

    doc = _load(REPO_ROOT / "PARITY_TRAJECTORY.json")
    checked = 0
    for t in doc["ticks_data"][::10]:
        for g in t["groups"]:
            if "representative" in g:
                members = sorted(g["representative"]["members"], key=lambda m: m[0])
                s = ";".join("%s%s%d" % (a, st, inc) for a, st, inc in members)
                assert native.hash32(s) == g["checksum"], t["tick"]
                checked += 1
    assert checked >= 5


# -- the sample traces ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_checker():
    return _jax_script("check_metrics_schema")


def test_flight_trace_equals_committed_sample(tmp_path, jax_checker):
    out = export_flight_trace.export(str(tmp_path), device="cpu")
    got = _load(out["sidecar"])
    want = _load(RUNLOGS / "sample_flight_n64.flight.trace.json")
    assert got["traceEvents"] == want["traceEvents"]
    assert _load(out["dissemination"]) == _load(RUNLOGS / "sample_dissemination_n64.json")
    paths = [out["runlog"], out["sidecar"]]
    assert check_metrics_schema.check(paths, verbose=False) == []
    assert jax_checker.check(paths, verbose=False) == []


def test_request_trace_equals_jax_script(tmp_path, jax_checker, capsys):
    # the JAX script writes beside itself: run a copy of it in a temporary folder
    (tmp_path / "jax" / "scripts").mkdir(parents=True)
    shutil.copy(SCRIPTS / "export_request_trace.py", tmp_path / "jax" / "scripts")
    proc = _run_jax([tmp_path / "jax" / "scripts" / "export_request_trace.py"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert export_request_trace.main(["--out-dir", str(tmp_path / "port"), "--device",
                                      "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    jax_runs = tmp_path / "jax" / "runlogs"
    want = _load(jax_runs / "sample_requests_n64.requests.trace.json")
    assert _load(out["sidecar"])["traceEvents"] == want["traceEvents"]
    assert "requests=%d breaches=%d" % (out["requests"], out["breaches"]) in proc.stdout
    # the run logs hold the same rows but for their provenance
    def rows(path):
        keep = []
        for line in open(path):
            row = json.loads(line)
            if row["kind"] in ("tick", "summary"):
                keep.append(row)
            elif row["kind"] == "event" and row["name"] != "hist.drain":
                keep.append(row)
        return keep
    assert rows(out["runlog"]) == rows(jax_runs / "sample_requests_n64.runlog.jsonl")
    paths = [out["runlog"], out["sidecar"]]
    assert check_metrics_schema.check(paths, verbose=False) == []
    assert jax_checker.check(paths, verbose=False) == []


# -- fuzz, checkpoints, run logs ----------------------------------------------


def test_fuzz_replay_gives_jax_verdicts(capsys):
    proc = _run_jax([SCRIPTS / "fuzz_sweep.py", "replay"] + FIXTURES)
    rc = fuzz_sweep.main(["replay"] + FIXTURES + ["--device", "cpu"])
    assert (rc, capsys.readouterr().out) == (proc.returncode, proc.stdout)
    assert rc == 0 and proc.stdout.count("ok   ") == len(FIXTURES) == 2


def test_fuzz_sweep_both_engines_clean(capsys):
    for engine in ("full", "scalable"):
        assert fuzz_sweep.main(["sweep", "--engine", engine, "--seeds", "0:6", "--device",
                                "cpu"]) == 0
        assert "6/6 scenarios clean (%s engine" % engine in capsys.readouterr().out


def _flipped_copy(tmp_path):
    dst = tmp_path / "flipped"
    shutil.copytree(SAMPLE_CKPT, dst)
    target = dst / "common.npz"
    data = bytearray(target.read_bytes())
    data[len(data) // 2] ^= 0xFF
    target.write_bytes(bytes(data))
    return dst


def test_ckpt_manifest_gives_jax_verdicts(tmp_path, capsys):
    jax = _jax_script("check_ckpt_manifest")
    flipped = _flipped_copy(tmp_path)
    for paths, bad in (([str(SAMPLE_CKPT)], False), ([str(flipped)], True),
                       ([str(RUNLOGS), str(tmp_path)], True)):
        found = check_ckpt_manifest.find_checkpoints(paths)
        assert found == jax.find_checkpoints(paths)
        got = check_ckpt_manifest.check(found, verbose=False)
        assert got == jax.check(found, verbose=False)
        assert bool(got) is bad
        assert check_ckpt_manifest.main(paths + ["-q"]) == int(bad)
    assert "CheckpointDigestError" in check_ckpt_manifest.check([str(flipped)], False)[0]
    # a family of one good and one corrupt checkpoint resumes from the good one
    family = tmp_path / "family"
    shutil.copytree(SAMPLE_CKPT, family / "ckpt-0000000006")
    shutil.copytree(flipped, family / "ckpt-0000000009")
    got = check_ckpt_manifest.repair_scan(str(family), verbose=False)
    assert got == jax.repair_scan(str(family), verbose=False)
    assert got["resume_from"][0] == 6 and [c[0] for c in got["corrupt"]] == [9]
    assert check_ckpt_manifest.main(["--repair-scan", str(family)]) == 0
    capsys.readouterr()


def test_metrics_schema_gives_jax_verdicts(tmp_path, jax_checker):
    committed = [str(p) for p in sorted(RUNLOGS.glob("*.runlog.jsonl"))
                 + sorted(RUNLOGS.glob("*.trace.json"))]
    assert len(committed) >= 10
    assert check_metrics_schema.check(committed, verbose=False) == []
    assert jax_checker.check(committed, verbose=False) == []
    bad = tmp_path / "broken.runlog.jsonl"
    bad.write_text('{"kind": "tick", "metrics": {"route_queries": 1}}\nnot json\n'
                   '{"kind": "event", "name": "trace_sidecar", "path": "gone.trace.json"}\n'
                   '{"kind": "event", "name": "slo.window", "target": "route"}\n')
    sidecar = tmp_path / "broken.trace.json"
    sidecar.write_text('{"traceEvents": [{"ph": "X"}]}')
    paths = [str(bad), str(sidecar)]
    got = check_metrics_schema.check(paths, verbose=False)
    assert got == jax_checker.check(paths, verbose=False) and len(got) >= 4
    assert check_metrics_schema.main(paths) == 1


def test_metrics_schema_registries_equal_jax_and_the_port(jax_checker):
    assert check_metrics_schema.ROUTE_TICK_FIELDS == jax_checker.ROUTE_TICK_FIELDS
    assert check_metrics_schema.ROUTE_TICK_FIELDS == frozenset(RouteMetrics._fields)
    assert check_metrics_schema.ROUTE_EVENT_FIELDS == jax_checker.ROUTE_EVENT_FIELDS
    assert check_metrics_schema.REQTRACE_COUNT_FIELDS == poreq.COUNT_FIELDS
    assert check_metrics_schema.SLO_WINDOW_QS == pslo.WINDOW_QS


# -- the traffic gate ----------------------------------------------------------


def test_traffic_manifest_holds_the_jax_numbers():
    mine = traffic.load_manifest()["entries"]
    jax = _load(REPO_ROOT / "TRAFFIC_BUDGET.json")["entries"]
    assert set(mine) == set(jax) == {traffic.entry_name(c) for c in traffic.MESH_CONFIGS}
    for name, want in jax.items():
        assert mine[name] == want, name


def test_traffic_gate_clean_on_every_entry():
    assert traffic.check_against_manifest(device="cpu") == []
    assert traffic.check_against_manifest(["mesh-s2-n64"], device="cpu") == []


def test_traffic_gate_names_drift_and_refuses_a_failed_write(tmp_path, monkeypatch):
    doc = traffic.load_manifest()
    doc["entries"]["mesh-s4-n64"]["cap"] += 1
    p = tmp_path / "t.json"
    p.write_text(json.dumps(doc))
    found = traffic.check_against_manifest(path=p, device="cpu")
    assert [f.rule for f in found] == ["traffic-budget"] and "cap changed" in found[0].message
    monkeypatch.setattr(traffic, "MESH_CONFIGS", ({"shards": 3, "n": 64, "u": 128, "ticks": 1},))
    actual = traffic.collect_measurements(device="cpu")
    assert "error" in actual["mesh-s3-n64"]
    with pytest.raises(ValueError, match="refusing"):
        traffic.write_manifest(actual, tmp_path / "w.json")
    assert not (tmp_path / "w.json").exists()


# -- the live example and the device rule --------------------------------------


def test_sharded_app_answers_from_the_owner():
    keys = sharded_app.KEYS + tuple("key-%d" % i for i in range(28))
    hosts, rows = sharded_app.run(keys)
    assert len(hosts) == 3 and len(rows) == len(keys)
    for sk, owner, name, body in rows:
        assert owner in hosts
        assert body == "hello from %s for %s" % (name, sk)
    # the ports are the OS's, so the ring differs a run; with 32 keys the
    # chance that the entry node owns them all is 3**-32
    assert any(owner != hosts[0] for _, owner, _, _ in rows)  # some keys were relayed


TOOL_MAINS = {
    "export_parity_replay": (export_parity_replay.main, []),
    "export_parity_trajectory": (export_parity_trajectory.main, []),
    "export_request_trace": (export_request_trace.main, []),
    "export_flight_trace": (export_flight_trace.main, []),
    "fuzz_sweep": (fuzz_sweep.main, ["replay"] + FIXTURES[:1]),
    "traffic": (analysis_cli.main, ["--prong", "traffic"]),
}


@pytest.mark.parametrize("name", sorted(TOOL_MAINS))
def test_tools_run_on_the_card_unless_told(name, tmp_path, monkeypatch):
    """No tool that runs tensors falls back to the CPU: without a card and
    without ``--device cpu`` each raises before it does any work."""
    main, argv = TOOL_MAINS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


HOST_TOOL_MAINS = {
    "check_ckpt_manifest": (check_ckpt_manifest.main, [str(SAMPLE_CKPT), "-q"]),
    "check_metrics_schema": (check_metrics_schema.main,
                             [str(RUNLOGS / "sample_flight_n64.runlog.jsonl")]),
    "sharded_app": (sharded_app.main, []),
}


@pytest.mark.parametrize("name", sorted(HOST_TOOL_MAINS))
def test_host_tools_need_no_card(name, tmp_path, monkeypatch, capsys):
    """The tools that touch no tensor take no ``--device`` and run where no
    card is."""
    main, argv = HOST_TOOL_MAINS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert main(argv) == 0
    with pytest.raises(SystemExit):
        main(argv + ["--device", "cpu"])
    capsys.readouterr()
