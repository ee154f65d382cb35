"""Tracer subsystem (lib/trace/ rebuilt): remotely attachable event taps.

A copy of ``ringpop_tpu/utils/trace.py`` (the port imports nothing of the
JAX package): the same ``TRACE_EVENTS`` table, ``Tracer`` and
``TracerStore``.  The port's trace host is ``obs.sim_tap.SimTracerHost``;
the log sink writes through its ``logger`` and the channel sink forwards
through whatever ``channel`` the host holds.

``/trace/add`` subscribes a sink to a named internal event with a TTL;
sinks either log locally or forward the event blob to another node over the
channel (lib/trace/log.js, tchannel.js).  Wired events:
``membership.checksum.update`` — matching the reference
(lib/trace/config.js:22-36), sourced from Membership's ``checksumUpdate``
emission (lib/membership/index.js:77-94) — plus ``ring.checksum.computed``
(HashRing rebuilds) and ``sim.tick.metrics`` (per-tick simulation metric
rows via obs.sim_tap.SimTracerHost).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

DEFAULT_TTL_MS = 60 * 1000
MAX_TTL_MS = 5 * 60 * 1000


class TraceError(Exception):
    pass


TRACE_EVENTS: Dict[str, Dict[str, str]] = {
    # event name -> (emitter attribute path, event it maps to)
    "membership.checksum.update": {
        "emitter": "membership",
        "event": "checksumUpdate",
    },
    # ring rebuilt + rehashed (models/ring/host.py compute_checksum; the
    # blob carries {checksum, serverCount})
    "ring.checksum.computed": {
        "emitter": "ring",
        "event": "checksumComputed",
    },
    # per-tick simulation metrics re-published by a SimTracerHost
    # (obs/sim_tap.py) — lets TracerStore work against the simulation
    # engines, not just live nodes
    "sim.tick.metrics": {
        "emitter": "sim_events",
        "event": "tickMetrics",
    },
    # decoded flight-recorder event batches re-published by a
    # SimTracerHost drain (obs/sim_tap.py publish_flight_events; event
    # layout in obs/events.py)
    "sim.flight.events": {
        "emitter": "sim_events",
        "event": "flightEvents",
    },
}


class Tracer:
    """One (event, sink) subscription with expiry."""

    def __init__(self, ringpop: Any, event_name: str, sink_spec: Dict[str, Any],
                 expires_in_ms: Optional[int] = None):
        spec = TRACE_EVENTS.get(event_name)
        if spec is None:
            raise TraceError("unknown traceable event: %r" % event_name)
        self.ringpop = ringpop
        self.event_name = event_name
        self.sink_spec = dict(sink_spec)
        # a known event may still be unavailable on THIS host: e.g.
        # sim.tick.metrics sources from a SimTracerHost's sim_events —
        # a live Ringpop facade has no such emitter, and the miss must
        # surface as a clean TraceError (-> ringpop.trace.invalid over
        # the wire), not an unhandled AttributeError
        self.emitter = getattr(ringpop, spec["emitter"], None)
        if self.emitter is None:
            raise TraceError(
                "event %r is not available on this node (no %r emitter)"
                % (event_name, spec["emitter"])
            )
        self.internal_event = spec["event"]
        ttl = min(expires_in_ms or DEFAULT_TTL_MS, MAX_TTL_MS)
        self.expires_at_ms = time.time() * 1000.0 + ttl
        self._send = self._resolve_sink(sink_spec)
        self._listener = None

    def _resolve_sink(self, spec: Dict[str, Any]) -> Callable[[Any], None]:
        kind = spec.get("type")
        if kind == "log":
            def log_sink(blob: Any) -> None:
                self.ringpop.logger.info(
                    "ringpop trace", extra={"event": self.event_name, "blob": blob}
                )
            return log_sink
        if kind == "channel":
            host_port = spec.get("hostPort")
            endpoint = spec.get("serviceName") or "/trace/sink"
            if not host_port:
                raise TraceError("channel sink requires hostPort")

            def channel_sink(blob: Any) -> None:
                try:
                    self.ringpop.channel.request(
                        host_port,
                        endpoint,
                        head={"event": self.event_name},
                        body=blob,
                        timeout_s=5.0,
                    )
                except Exception:
                    self.ringpop.logger.warning(
                        "ringpop trace channel sink failed",
                        extra={"sink": host_port},
                    )
            return channel_sink
        raise TraceError("unknown sink type: %r" % kind)

    @property
    def key(self) -> tuple:
        return (self.event_name, self.sink_spec.get("type"),
                self.sink_spec.get("hostPort"))

    def connect(self) -> None:
        def listener(blob=None, *a, **kw):
            self._send(blob)
        self._listener = listener
        self.emitter.on(self.internal_event, listener)

    def disconnect(self) -> None:
        if self._listener is not None:
            self.emitter.remove_listener(self.internal_event, self._listener)
            self._listener = None


class TracerStore:
    """Dedups tracers by (event, sink) and expires them (lib/trace/store.js)."""

    def __init__(self, ringpop: Any):
        self.ringpop = ringpop
        self.tracers: Dict[tuple, Tracer] = {}
        self._expiry_timer = None
        self._lock = threading.Lock()

    def add(self, tracer: Tracer) -> Tracer:
        with self._lock:
            existing = self.tracers.get(tracer.key)
            if existing is not None:
                existing.expires_at_ms = tracer.expires_at_ms
                return existing
            self.tracers[tracer.key] = tracer
        tracer.connect()
        self._schedule_expiry()
        return tracer

    def remove(self, event_name: str, sink_spec: Dict[str, Any]) -> bool:
        key = (event_name, sink_spec.get("type"), sink_spec.get("hostPort"))
        with self._lock:
            tracer = self.tracers.pop(key, None)
        if tracer is not None:
            tracer.disconnect()
            return True
        return False

    def _schedule_expiry(self) -> None:
        if self._expiry_timer is not None:
            self.ringpop.timers.clear_timeout(self._expiry_timer)
        self._expiry_timer = self.ringpop.timers.set_timeout(
            self._expire_due, 1.0
        )

    def _expire_due(self) -> None:
        now = time.time() * 1000.0
        with self._lock:
            due = [t for t in self.tracers.values() if t.expires_at_ms <= now]
            for t in due:
                del self.tracers[t.key]
        for t in due:
            t.disconnect()
        with self._lock:
            alive = bool(self.tracers)
        if alive:
            self._schedule_expiry()
        else:
            self._expiry_timer = None

    def destroy(self) -> None:
        if self._expiry_timer is not None:
            self.ringpop.timers.clear_timeout(self._expiry_timer)
            self._expiry_timer = None
        with self._lock:
            tracers = list(self.tracers.values())
            self.tracers = {}
        for t in tracers:
            t.disconnect()
