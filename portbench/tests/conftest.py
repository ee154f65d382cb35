"""Fixtures of the benchmark's own tests (CPU, tiny sizes).

``tiny_checkout`` is a copy of the benchmark beside the program (linked)
with two tiny cells added as files only, as a later change would add a
cell; :func:`run_cell` runs one of its cells in a fresh process, with
optional code run first (a fault planted in the timed path).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_SIM = "tiny-sim.pulse"
TINY_STORM = "tiny-storm.cycle"


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips on machines without one)")


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_tiny_cells(root: str) -> None:
    """Two tiny cells as new files (configs, mixes, cells) and new entries
    of BENCHMARK.json: no file of the harness is edited."""
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "ringpop-1k.json")) as f:
        sim = json.load(f)
    with open(os.path.join(pb, "configs", "ringpop-storm-1m.json")) as f:
        storm = json.load(f)
    _write(os.path.join(pb, "configs", "tiny-sim.json"),
           dict(sim, name="tiny-sim", engine=dict(sim["engine"], n=16)))
    _write(os.path.join(pb, "configs", "tiny-storm.json"),
           dict(storm, name="tiny-storm", engine=dict(storm["engine"], n=256, u=192)))
    _write(os.path.join(pb, "traffic", "tiny-pulse.json"),
           dict(clusters=4, chunk_ticks=10, period=5, phase=2, kill_fraction=0.125,
                revive_after=10, draw="live"))
    _write(os.path.join(pb, "traffic", "tiny-cycle.json"),
           dict(chunk_ticks=20, period=20, phase=2, kill_fraction=0.1, revive_after=8,
                draw="any"))
    _write(os.path.join(pb, "workloads", TINY_SIM + ".json"),
           dict(config="tiny-sim", traffic="tiny-pulse", converge_ticks=4))
    _write(os.path.join(pb, "workloads", TINY_STORM + ".json"),
           dict(config="tiny-storm", traffic="tiny-cycle", warm_cycles=2))
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"] += [
        dict(name=TINY_SIM, config="tiny-sim", traffic="tiny-pulse", chips=1, why="test"),
        dict(name=TINY_STORM, config="tiny-storm", traffic="tiny-cycle", chips=1, why="test"),
    ]
    sim_cells = {w["name"] for w in bench["workloads"] if w["config"] == "ringpop-1k"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY_SIM if set(m["workloads"]) & sim_cells else TINY_STORM)
    _write(bench_path, bench)


@pytest.fixture(scope="session")
def tiny_checkout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    os.symlink(os.path.join(REPO, "ringpop_tpu_torch"), os.path.join(root, "ringpop_tpu_torch"))
    add_tiny_cells(root)
    return root


def run_cell(root: str, cell: str, seed: int, *flags: str, before: str = "",
             seconds: float = 1.0, timeout: float = 600):
    """One run of ``cell`` on the CPU in a fresh process from ``root``;
    ``before`` is Python run first (after the harness is imported).
    Returns ``(exit code, result or None, standard error)``."""
    script = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, %r)
        from portbench import run as R
        %s
        code, result = R.run(%r)
        print(json.dumps(result))
        sys.exit(code)
    """) % (root, textwrap.dedent(before),
            ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
             "--trace", "0", "--device", "cpu", *flags])
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                          text=True, timeout=timeout, env=env)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1] != "null" else None
    return proc.returncode, result, proc.stderr
