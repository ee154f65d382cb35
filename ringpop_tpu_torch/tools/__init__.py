"""The port's operator tools: one module for each command-line entry point
of the JAX package, under the JAX script's own file name.

Each runs as ``python -m ringpop_tpu_torch.tools.<name>``, takes the JAX
script's arguments, and writes under
:data:`RUNS_DIR` (``runs_torch/`` at the repo root, git-ignored) unless
told otherwise, never over a committed JAX artifact.  The tools that run
tensors (the exporters and ``fuzz_sweep``) also take ``--device``: the
card unless ``--device cpu``, and without a card ``cpu`` must be asked
for.  The host-only tools (``check_ckpt_manifest``,
``check_metrics_schema``, ``sharded_app``) touch no tensor, take no
``--device`` and need no card.

=============================  =========================================
``tools.export_parity_replay``       ``scripts/export_parity_replay.py``
``tools.export_parity_trajectory``   ``scripts/export_parity_trajectory.py``
``tools.export_request_trace``       ``scripts/export_request_trace.py``
``tools.export_flight_trace``        ``scripts/export_flight_trace.py``
``tools.fuzz_sweep``                 ``scripts/fuzz_sweep.py``
``tools.check_ckpt_manifest``        ``scripts/check_ckpt_manifest.py``
``tools.check_metrics_schema``       ``scripts/check_metrics_schema.py``
``tools.sharded_app``                ``examples/sharded_app.py``
``analysis.traffic``                 ``scripts/check_traffic_model.py``
=============================  =========================================

The traffic gate sits with the other budget gates: ``python -m
ringpop_tpu_torch.analysis --prong traffic`` (on the card unless
``--device cpu``).
"""

from __future__ import annotations

from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
RUNS_DIR = REPO_ROOT / "runs_torch"


def default_path(name: str) -> str:
    """``runs_torch/<name>``, the directory made on the way."""
    RUNS_DIR.mkdir(parents=True, exist_ok=True)
    return str(RUNS_DIR / name)

