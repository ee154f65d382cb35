"""On the card: a tiny cell through the kernels, traced.  Run there with
``python3 -m pytest portbench/tests -m cuda``."""

import os
import subprocess
import sys

import pytest
import torch

from portbench.tests.conftest import TINY_SIM, TINY_STORM


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kernels", [(TINY_SIM, ("apply_updates", "fused_stream")),
                                          (TINY_STORM, ("exchange",))])
def test_traced_cell_on_the_card(card, tiny_checkout, cell, kernels):
    import json

    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           "77", "--seconds", "1", "--trace", "1"], cwd=tiny_checkout,
                          capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    for k in kernels:
        assert 0 < result["metrics"][k + "_roofline"]["value"] <= 105
