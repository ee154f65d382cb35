"""Generate the request-observatory sample artifacts from the port: the
counterpart of the JAX package's ``scripts/export_request_trace.py``.

Runs an n=64 ``RoutedStorm`` (``u=192``, ``suspicion_ticks=4``, 256
queries a tick over 1,024 keys) with the sampled per-request trace buffer
(a quarter of the key space) and the route histograms on, drained in 8
windows of 5 ticks that feed the sliding-window SLO plane; a quarter of
the nodes die in window 2 and revive in window 3.  Every window's sampled
counters are reconciled against its ``RouteMetrics`` (``obs.requests.
reconcile_metrics``).  Writes, under ``--out-dir`` (default
``runs_torch/``):

- ``sample_requests_n64.runlog.jsonl``: per-tick engine and route rows,
  one ``reqtrace.drain``, ``hist.drain`` and ``slo.window`` row a window,
  the ``slo.breach`` rows of the burst;
- ``sample_requests_n64.requests.trace.json``: the Perfetto request
  sidecar (``obs.requests.export_request_trace``), whose ``traceEvents``
  equal the committed ``runlogs/`` sample's.

Usage: python -m ringpop_tpu_torch.tools.export_request_trace
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
from ringpop_tpu_torch.models.route import reqtrace as rt
from ringpop_tpu_torch.models.route.plane import RoutedStorm, RouteParams
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.storm import StormSchedule
from ringpop_tpu_torch.obs import histograms as oh
from ringpop_tpu_torch.obs import requests as oreq
from ringpop_tpu_torch.obs.recorder import RunRecorder
from ringpop_tpu_torch.obs.slo import SLOBackpressure, SLOTarget, SLOWindowPlane
from ringpop_tpu_torch.tools import RUNS_DIR

N = 64
WINDOW_TICKS = 5
WINDOWS = 8
BURST_WINDOWS = (2, 3)  # churn burst: kill in window 2, rejoin in 3
RUN_ID = "sample_requests_n%d" % N


def export(out_dir: str, device=None) -> dict:
    """Run and write both artifacts; returns their paths and counts."""
    os.makedirs(out_dir, exist_ok=True)
    qpt = 256
    route = RouteParams(
        n=N,
        queries_per_tick=qpt,
        key_space=1024,
        histograms=True,
        reqtrace=True,
        # drop-free at worst case for one drain window
        req_capacity=rt.req_capacity_for(qpt, WINDOW_TICKS),
        req_sample_log2=2,  # trace 1/4 of the key space
    )
    rs = RoutedStorm(N, params=es.ScalableParams(n=N, u=192, suspicion_ticks=4), route=route,
                     seed=1, device=device)
    rec = RunRecorder(
        os.path.join(out_dir, "%s.runlog.jsonl" % RUN_ID),
        run_id=RUN_ID,
        config={"tool": "ringpop_tpu_torch/tools/export_request_trace.py", "seed": 1},
    )
    open(rec.path, "w").close()  # the recorder appends: regenerate in place
    rs.attach_recorder(rec)
    backpressure = SLOBackpressure(base_period_ms=200.0)
    slo = SLOWindowPlane(
        SLOTarget(name="route", success_objective=0.999, burn_alert=2.0),
        window_len=3,
        recorder=rec,
        consumer=backpressure,
    )

    burst = np.random.default_rng(7).choice(N, N // 4, replace=False)
    all_requests: List[dict] = []
    tick = 0
    for w in range(WINDOWS):
        sched = StormSchedule(ticks=WINDOW_TICKS, n=N)
        if w == BURST_WINDOWS[0]:
            sched.kill[1, burst] = True
        elif w == BURST_WINDOWS[1]:
            sched.revive[1, burst] = True
        _, rm = rs.run(sched)
        tick += WINDOW_TICKS
        hist = oh.host_counts(rs.rstate.hist)  # the window's counts: a reset follows
        rs.drain_histograms(reset=True)
        slo.observe_route_window(tick, hist, rm)
        drained = rs.drain_requests(reset=True)
        if drained["drops"]:
            raise AssertionError("the sized capacity must be drop-free")
        recon = oreq.reconcile_metrics(
            np.asarray([drained["counts"][f] for f in oreq.COUNT_FIELDS]), rm
        )
        if not all(v["ok"] for v in recon.values()):
            raise AssertionError("sampled counters exceed the window's metrics: %r" % recon)
        all_requests.extend(drained["records"])

    if not slo.breaches:
        raise AssertionError("the churn burst must fire a breach")
    if backpressure.factor() != 1.0:
        raise AssertionError("the quiet tail windows must clear the breach")
    sidecar = rec.record_trace_sidecar(oreq.export_request_trace(all_requests, N),
                                       name="requests")
    rec.finish(requests_traced=len(all_requests), slo_breaches=slo.breaches, windows=WINDOWS,
               window_ticks=WINDOW_TICKS)
    return {"runlog": rec.path, "sidecar": sidecar, "requests": len(all_requests),
            "breaches": slo.breaches}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="export-request-trace")
    p.add_argument("--out-dir", default=str(RUNS_DIR))
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; without a card, cpu must be asked for")
    args = p.parse_args(argv)
    resolve_device(args.device)  # before any file is made
    out = export(args.out_dir, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
