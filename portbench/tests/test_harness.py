"""The harness finds every piece by name and runs a cell end to end."""

import pytest

from portbench.tests.conftest import TINY_SIM, TINY_STORM, run_cell


@pytest.mark.parametrize("cell,e2e", [(TINY_SIM, "node_ticks_per_s"),
                                      (TINY_STORM, "storm_ms_per_tick")])
def test_cell_added_as_files_runs_end_to_end(tiny_checkout, cell, e2e):
    code, result, err = run_cell(tiny_checkout, cell, 2**31 + 17)
    assert code == 0, err[-2000:]
    assert result["correct"] is True, err[-2000:]
    assert set(result["metrics"]) == {e2e, "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    # the numbers compared come last, each with its limit
    assert list(result)[-1] == "compared"
    assert all(v["limit"] == 0 for v in result["compared"].values())
    assert "limit 0" in err.strip().splitlines()[-1]


def test_traced_run_reports_per_layer_metrics(tiny_checkout):
    code, result, err = run_cell(tiny_checkout, TINY_STORM, 5, "--trace", "1")
    assert code == 0, err[-2000:]
    assert result["correct"] is True
    # on the CPU only the program's own counter has something to read
    assert set(result["metrics"]) == {"host_reads_per_tick.storm"}
    assert result["metrics"]["host_reads_per_tick.storm"]["value"] > 0
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_unknown_cell_is_refused(tiny_checkout):
    code, result, _ = run_cell(tiny_checkout, "no-such.cell", 1)
    assert code == 2 and result is None


def test_no_card_means_no_result(tiny_checkout):
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", TINY_SIM,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tiny_checkout, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_only_the_checkout_contents_refuse(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark (no program)
    exits non-zero and prints no result."""
    import os
    import shutil
    import subprocess
    import sys

    from portbench.tests.conftest import REPO

    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "ringpop-1k.churn-b32", "--seed", "1", "--seconds", "1", "--trace",
                           "0", "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
