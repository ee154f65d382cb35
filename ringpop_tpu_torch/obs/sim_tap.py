"""SimTracerHost — TracerStore/Tracer against the simulation engines.

The reference's trace taps (lib/trace/) attach to a live ringpop node's
internal emitters.  The simulation drivers (SimCluster /
BatchedSimClusters / ScalableCluster) have no facade, so this adapter
provides the minimal surface ``Tracer``/``TracerStore`` need — a
``logger``, a ``timers`` plane, an optional ``channel`` for forwarding
sinks, and named emitters — and re-publishes per-tick metric rows as
``tickMetrics`` events (the ``sim.tick.metrics`` trace event in
utils/trace.py TRACE_EVENTS) and decoded flight-recorder drains as
``flightEvents`` (``sim.flight.events``).

A copy of ``ringpop_tpu/obs/sim_tap.py`` over the port's own copies of
the trace store, timers, emitter and null logger.  The port's
``SimCluster.attach_tracer`` takes one; its ``drain_events`` publishes
every decoded window through it.
"""

from __future__ import annotations

from typing import Any, Optional

from ringpop_tpu_torch.net.timers import Timers
from ringpop_tpu_torch.obs.recorder import _jsonable, iter_tick_rows
from ringpop_tpu_torch.utils.config import EventEmitter
from ringpop_tpu_torch.utils.stats import NullLogger
from ringpop_tpu_torch.utils.trace import TracerStore


class SimTracerHost:
    """Adapter: a simulation driver wearing enough of the Ringpop facade
    for the trace subsystem (and other observers) to attach."""

    def __init__(
        self,
        cluster: Any = None,
        logger: Any = None,
        timers: Optional[Timers] = None,
        channel: Any = None,
    ):
        self.cluster = cluster
        self.logger = logger or NullLogger()
        self.timers = timers or Timers()
        self.channel = channel
        # the sim.tick.metrics trace event sources from this emitter
        self.sim_events = EventEmitter()
        self.tracers = TracerStore(self)

    def publish_tick_metrics(self, metrics: Any, start_tick: int = 0) -> int:
        """Re-publish a metrics row or stacked [T]-series as one
        ``tickMetrics`` event per tick.  Returns ticks published."""
        published = 0
        for t, row in enumerate(iter_tick_rows(metrics)):
            self.sim_events.emit(
                "tickMetrics",
                {"tick": start_tick + t, "metrics": _jsonable(row)},
            )
            published += 1
        return published

    def publish_flight_events(
        self, events: Any, drops: int = 0, batch: int = 256
    ) -> int:
        """Re-publish a decoded flight-recorder stream (``obs.events``)
        as ``flightEvents`` emissions (the ``sim.flight.events`` trace
        event), batched so a long drain does not flood forwarding sinks
        one datagram per protocol event.  Returns events published."""
        events = list(events)
        for lo in range(0, len(events), batch):
            self.sim_events.emit(
                "flightEvents",
                {
                    "events": events[lo : lo + batch],
                    "dropped": int(drops),
                    "offset": lo,
                    "total": len(events),
                },
            )
        return len(events)

    def destroy(self) -> None:
        self.tracers.destroy()
