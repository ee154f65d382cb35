"""Driver of the lossy quiet cluster: the storm's driver with the span log.

The engine, the timed call (one cycle of ``ScalableCluster.run``, then
the ring digest) and the storm's checks are :mod:`.storm`'s.  What this
driver adds:

- In a traced run only (``run.py --trace 1``: :meth:`counters` first
  runs with the profiler on, at the window's start), the program's span
  log (``ringpop_tpu_torch.obs.perf``), installed until the judge; or the
  log a caller has installed.  An untraced window runs the program with
  no log, as the storm's does.  :meth:`counters` reads it:
  ``gate.open`` (gated phases that ran) and ``ping_req_ns``, the host ns
  of every ``ping_req`` span (the ping-req fanout), beside the storm's
  ``host_read``.  A program without such a span or counter gives no
  key, and its metric reads nothing.
- The control: the frozen engine with ``packet_loss`` 0 in the program's
  place, a network that loses nothing.
- The judge: the storm's numbers, then :mod:`portbench.reference.epidemic`'s
  over the window's last cycle.
"""

from __future__ import annotations

import torch

from portbench.drivers import storm
from portbench.lib.snapshot import Snapshot
from portbench.reference import epidemic as epi
from portbench.reference import storm as ref

COUNTERS = ("gate.open",)


class Driver(storm.Driver):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._tracing = None
        self.totals = {"ticks": 0, "suspects": 0, "refutes": 0}

    def setup(self) -> None:
        if not self.control:
            super().setup()
            return
        # the guarantee the control breaks: the network's stated loss
        self.sim = ref.RefStorm(self.n, dict(self.engine, packet_loss=0.0), self.seed,
                                self.device, self.replica_points)
        for _ in range(self.warm_cycles):
            _, self.start_digest = self._cycle()
            self.chunk_index += 1
        self.start_snap = Snapshot(self.sim.state)
        self.last_snap = Snapshot(self.sim.state)

    def chunk(self) -> int:
        ticks = super().chunk()
        m = self.last_metrics
        self.totals["ticks"] += ticks
        self.totals["suspects"] += int(m.suspects_published.sum())
        self.totals["refutes"] += int(m.refutes_published.sum())
        return ticks

    def counters(self) -> dict:
        out = super().counters()
        if self.control:
            return out
        from ringpop_tpu_torch.obs import perf

        if perf.active() is None and torch._C._autograd._profiler_enabled():
            self._tracing = perf.tracing(perf.DispatchTimer())
            self._tracing.__enter__()
        timer = perf.active()
        if timer is None:
            return out
        out.update({k: timer.counters[k] for k in COUNTERS if k in timer.counters})
        fanout = [end - start for name, start, end, _, _ in timer.log
                  if name == "ping_req" and end is not None]
        if fanout:
            out["ping_req_ns"] = sum(fanout)
        return out

    def judge(self, log) -> list:
        if self._tracing is not None:
            self._tracing.__exit__(None, None, None)
            self._tracing = None
        start, end = self.last_snap.state, self.sim.state
        kill, revive = self.plan.chunk(self.last_chunk)
        touched = torch.as_tensor(kill.any(0) | revive.any(0), device=end.proc_alive.device)
        up = start.proc_alive & end.proc_alive & ~touched
        own = epi.judge(engine_params=self.engine, start=start, end=end, up=up,
                        metrics=self.last_metrics, totals=self.totals, log=log)
        return super().judge(log) + own
