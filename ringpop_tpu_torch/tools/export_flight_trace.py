"""Generate the flight-recorder sample artifacts from the port: the
counterpart of the JAX package's ``scripts/export_flight_trace.py``.

Runs an n=64 full-fidelity cluster (fast checksums, ``suspicion_ticks=6``,
seed 1) with the device-side flight recorder through a 40-tick churn
window: node 5 dies at tick 3 (suspect, then faulty) and revives at 20.
The events are reconciled against the metrics (``obs.events.reconcile``,
every counter must match, no drops).  Writes, under ``--out-dir``
(default ``runs_torch/``):

- ``sample_flight_n64.runlog.jsonl``: per-tick metrics, the flight drain
  and the sidecar link;
- ``sample_flight_n64.flight.trace.json``: the Chrome-trace sidecar
  (``SimCluster.export_flight_trace``), whose ``traceEvents`` equal the
  committed ``runlogs/`` sample's;
- ``sample_dissemination_n64.json``: per-rumor convergence ticks, the
  dissemination-latency histogram and the reconciliation table.

Usage: python -m ringpop_tpu_torch.tools.export_flight_trace
       [--out-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.obs import events as obs_events
from ringpop_tpu_torch.obs.recorder import RunRecorder
from ringpop_tpu_torch.tools import RUNS_DIR

N = 64
TICKS = 40
RUN_ID = "sample_flight_n%d" % N


def export(out_dir: str, device=None) -> dict:
    """Run and write the three artifacts; returns their paths and counts."""
    os.makedirs(out_dir, exist_ok=True)
    params = engine.SimParams(n=N, checksum_mode="fast", suspicion_ticks=6, flight_recorder=True)
    sim = SimCluster(n=N, params=params, seed=1, device=device)
    rec = RunRecorder(
        os.path.join(out_dir, "%s.runlog.jsonl" % RUN_ID),
        run_id=RUN_ID,
        config={"tool": "ringpop_tpu_torch/tools/export_flight_trace.py", "seed": 1},
    )
    open(rec.path, "w").close()  # the recorder appends: regenerate in place
    sim.attach_recorder(rec)

    sim.bootstrap()
    sim.drain_events()  # the sample window starts after the bootstrap
    sched = EventSchedule(ticks=TICKS, n=N)
    sched.kill[3, 5] = True
    sched.revive[TICKS // 2, 5] = True
    metrics = sim.run(sched)

    events = sim.drain_events(reset=False)
    reconciliation = obs_events.reconcile(events, metrics)
    if not all(v["match"] for v in reconciliation.values()):
        raise AssertionError("events and metrics disagree: %r" % reconciliation)
    if sim.event_drops():
        raise AssertionError("the event buffer dropped records")
    sidecar = rec.record_trace_sidecar(sim.export_flight_trace(events=events), name="flight")

    wavefronts = obs_events.rumor_wavefronts(events)
    summary = obs_events.dissemination_summary(wavefronts)
    summary["run"] = {
        "n": N,
        "ticks": TICKS,
        "seed": 1,
        "events_decoded": len(events),
        "event_drops": 0,
        "schedule": "kill node 5 @ tick 3, revive @ tick %d" % (TICKS // 2),
    }
    summary["reconciliation"] = reconciliation
    dissem_path = os.path.join(out_dir, "sample_dissemination_n%d.json" % N)
    with open(dissem_path, "w", encoding="utf-8") as fh:
        json.dump(summary, fh, indent=1, sort_keys=True)
        fh.write("\n")
    rec.finish(events_decoded=len(events), rumors=len(wavefronts),
               converged=bool(np.asarray(metrics.converged)[-1]))
    return {"runlog": rec.path, "sidecar": sidecar, "dissemination": dissem_path,
            "events": len(events)}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="export-flight-trace")
    p.add_argument("--out-dir", default=str(RUNS_DIR))
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; without a card, cpu must be asked for")
    args = p.parse_args(argv)
    resolve_device(args.device)  # before any file is made
    print(json.dumps(export(args.out_dir, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
