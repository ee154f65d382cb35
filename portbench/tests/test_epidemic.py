"""A lossy quiet cell added as files runs end to end on the CPU, reports
the fanout's per-layer metrics and the storm's host reads in a traced
run, and its control (a network that loses nothing) comes out not
correct."""

import json
import os
import shutil

import pytest

from portbench.tests.conftest import run_cell

TINY_EPIDEMIC = "tiny-epidemic.quiet"
PER_LAYER = ("ping_req_host_ms_per_tick.epidemic", "gates_open_per_tick.epidemic")
# the storm's per-layer metrics, which the cell reports too (on the CPU
# only the host reads: the others read the card's records)
STORM_LAYER = ("host_reads_per_tick.storm", "launches_per_tick.storm",
               "engine_device_ms_per_tick.storm", "device_busy_pct.storm")
OWN = ("loss_violations", "refute_violations", "suspicion_violations")


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="module")
def epidemic_checkout(tiny_checkout, tmp_path_factory):
    """The tiny checkout with a 1,024-node cell at 20% loss (enough false
    suspicions that some are refuted inside every 20-tick cycle), added as
    files and as new entries of BENCHMARK.json."""
    root = str(tmp_path_factory.mktemp("epidemic"))
    shutil.copytree(tiny_checkout, root, symlinks=True, dirs_exist_ok=True)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "ringpop-epidemic-100k.json")) as f:
        cfg = json.load(f)
    _write(os.path.join(pb, "configs", "tiny-epidemic.json"),
           dict(cfg, name="tiny-epidemic",
                engine=dict(cfg["engine"], n=1024, u=256, packet_loss=0.2), replica_points=4))
    with open(os.path.join(pb, "traffic", "quiet.json")) as f:
        quiet = json.load(f)
    _write(os.path.join(pb, "traffic", "tiny-quiet.json"),
           dict(quiet, chunk_ticks=20, period=20))
    _write(os.path.join(pb, "workloads", TINY_EPIDEMIC + ".json"),
           dict(config="tiny-epidemic", traffic="tiny-quiet", warm_cycles=2))
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(name=TINY_EPIDEMIC, config="tiny-epidemic",
                                   traffic="tiny-quiet", chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in PER_LAYER + STORM_LAYER + ("storm_ms_per_tick",):
            m["workloads"].append(TINY_EPIDEMIC)
    _write(bench_path, bench)
    return root


def test_lossy_cell_runs_end_to_end_and_reports_its_per_layer_metrics(epidemic_checkout):
    code, result, err = run_cell(epidemic_checkout, TINY_EPIDEMIC, 2**31 + 23)
    assert code == 0, err[-2000:]
    assert result["correct"] is True, err[-2000:]
    assert set(result["metrics"]) == {"storm_ms_per_tick", "setup_s"}
    compared = result["compared"]
    # the storm's five numbers, then the lossy cluster's three, all 0
    assert list(compared)[-3:] == list(OWN)
    assert len(compared) == 8 and all(v["value"] == 0 for v in compared.values())
    assert "false suspects" in err

    code, result, err = run_cell(epidemic_checkout, TINY_EPIDEMIC, 7, "--trace", "1")
    assert code == 0, err[-2000:]
    assert result["correct"] is True
    assert set(result["metrics"]) == set(PER_LAYER) | {"host_reads_per_tick.storm"}
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["ping_req_host_ms_per_tick.epidemic"] > 0
    # at 20% loss the fanout opens every tick, and so do most gated phases
    assert 1 <= got["gates_open_per_tick.epidemic"] <= 8
    # eight gated reads a tick, and on the CPU two walks of a read a step
    # at the least
    assert got["host_reads_per_tick.storm"] >= 8 + 2


def test_lossy_cell_control_is_not_correct(epidemic_checkout):
    code, result, err = run_cell(epidemic_checkout, TINY_EPIDEMIC, 2**31 + 24, "--control")
    assert code == 0, err[-2000:]
    assert result["correct"] is False
    compared = result["compared"]
    # a network that loses nothing: every tick of the last cycle is out
    # of the band
    assert compared["loss_violations"]["value"] == 20
    assert compared["window_mismatch"]["value"] > 0
    for name in ("refute_violations", "suspicion_violations", "checksum_mismatch",
                 "ring_mismatch", "plan_mismatch"):
        assert compared[name]["value"] == 0, name
