"""The port's trace tap against the JAX package's: ``utils/trace.py``
(``TRACE_EVENTS``, ``Tracer``, ``TracerStore``), ``net/timers.py``,
``utils/config.EventEmitter``, ``obs/sim_tap.SimTracerHost`` and
``SimCluster.attach_tracer`` with ``drain_events`` publishing through it;
then ``emit_resolution_stat`` on ``SimCluster`` and ``ScalableCluster``.

Both packages' clusters run the same seed and schedule at n=16, each with a
log-sink tracer on ``sim.tick.metrics`` and ``sim.flight.events``: the
records the sinks see must be equal.  Expiry runs on ``FakeTimers``.
Tolerance: none.
"""

from __future__ import annotations

import numpy as np
import pytest

from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.cluster import EventSchedule as JaxSchedule
from ringpop_tpu.models.sim.cluster import SimCluster as JaxSimCluster
from ringpop_tpu.models.sim.storm import ScalableCluster as JaxScalable
from ringpop_tpu.net import timers as jtimers
from ringpop_tpu.obs import sim_tap as jtap
from ringpop_tpu.obs import statsd_bridge as jsb
from ringpop_tpu.utils import config as jconfig
from ringpop_tpu.utils import trace as jtrace
from ringpop_tpu.utils.stats import CapturingStatsd
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.models.sim.storm import ScalableCluster
from ringpop_tpu_torch.net import timers as ptimers
from ringpop_tpu_torch.obs import sim_tap as ptap
from ringpop_tpu_torch.obs import statsd_bridge as psb
from ringpop_tpu_torch.utils import config as pconfig
from ringpop_tpu_torch.utils import stats as pstats
from ringpop_tpu_torch.utils import trace as ptrace
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

N, TICKS = 16, 12


class ListLogger:
    def __init__(self):
        self.records = []
        self.warnings = []

    def info(self, msg, extra=None, **kw):
        self.records.append((msg, extra or kw))

    def warning(self, msg, extra=None, **kw):
        self.warnings.append((msg, extra or kw))

    def debug(self, *a, **k):
        pass

    warn = warning
    error = debug


class RaisingLogger(ListLogger):
    def info(self, msg, extra=None, **kw):
        raise RuntimeError("sink down")


def test_trace_tables_and_host_pieces_equal_jax():
    assert ptrace.TRACE_EVENTS == jtrace.TRACE_EVENTS
    assert (ptrace.DEFAULT_TTL_MS, ptrace.MAX_TTL_MS) == (jtrace.DEFAULT_TTL_MS, jtrace.MAX_TTL_MS)
    # the emitter: on/once/remove/emit/listener_count in the same order
    for mod in (jconfig, pconfig):
        seen = []
        em = mod.EventEmitter()
        f = em.on("x", lambda v: seen.append(("on", v)))
        em.once("x", lambda v: seen.append(("once", v)))
        em.emit("x", 1)
        em.emit("x", 2)
        em.remove_listener("x", f)
        em.emit("x", 3)
        assert em.listener_count("x") == 0
        if mod is jconfig:
            want = seen
    assert seen == want == [("on", 1), ("once", 1), ("on", 2)]
    # fake timers fire in time order on advance, as JAX's
    for mod in (jtimers, ptimers):
        t, fired = mod.FakeTimers(start_ms=1000), []
        t.set_timeout(lambda: fired.append("b"), 2.0)
        h = t.set_timeout(lambda: fired.append("x"), 1.0)
        t.set_timeout(lambda: fired.append("a"), 0.5)
        t.clear_timeout(h)
        assert t.advance(1.5) == 1 and t.advance(1.0) == 1 and t.now_ms() == 3500
        if mod is jtimers:
            want = fired
    assert fired == want == ["a", "b"]
    logger = pstats.NullLogger()
    for call in (logger.debug, logger.info, logger.warning, logger.warn, logger.error):
        call("x", extra={})


def _tapped(mod_tap, mod_trace, mod_timers, cluster):
    host = mod_tap.SimTracerHost(cluster, logger=ListLogger(), timers=mod_timers.FakeTimers())
    for event in ("sim.tick.metrics", "sim.flight.events"):
        host.tracers.add(mod_trace.Tracer(host, event, {"type": "log"}))
    cluster.attach_tracer(host)
    return host


def _jax_cluster():
    return JaxSimCluster(n=N, params=je.SimParams(
        n=N, checksum_mode="fast", suspicion_ticks=6, flight_recorder=True, histograms=True,
        fused_tick="xla", event_capacity=4096), seed=3)


def _port_cluster():
    return SimCluster(n=N, params=pe.SimParams(
        n=N, checksum_mode="fast", suspicion_ticks=6, flight_recorder=True, histograms=True,
        event_capacity=4096), seed=3, device="cpu")


def test_sim_tap_records_equal_jax():
    j, p = _jax_cluster(), _port_cluster()
    jh = _tapped(jtap, jtrace, jtimers, j)
    ph = _tapped(ptap, ptrace, ptimers, p)
    for c in (j, p):
        c.bootstrap()
    assert p.drain_events() == j.drain_events()
    jm = j.run(JaxSchedule.churn_window(TICKS, N))
    pm = p.run(EventSchedule.churn_window(TICKS, N))
    assert ph.publish_tick_metrics(pm, start_tick=1) == jh.publish_tick_metrics(jm, start_tick=1) == TICKS
    # a small batch splits the window into several flightEvents records
    events = p.drain_events(reset=False)
    assert ph.publish_flight_events(events, drops=0, batch=64) == len(events)
    jh.publish_flight_events(j.drain_events(reset=False), drops=0, batch=64)
    assert p.drain_events() == j.drain_events()
    assert ph.logger.records == jh.logger.records
    blobs = [extra["blob"] for _, extra in ph.logger.records]
    ticks = [b for b in blobs if "metrics" in b]
    flights = [b for b in blobs if "events" in b]
    assert [b["tick"] for b in ticks] == list(range(1, TICKS + 1))
    assert ticks[0]["metrics"]["pings_sent"] == int(pm.pings_sent[0])
    # every flightEvents record of the batch=64 window publish, in order
    window = [b for b in flights if b["total"] == len(events) and len(b["events"]) <= 64]
    assert [b["offset"] for b in window] == list(range(0, len(events), 64))
    assert [e for b in window for e in b["events"]] == events
    assert flights and all(b["dropped"] == 0 for b in flights)
    # removal detaches the sink; destroy clears the store
    ph.tracers.remove("sim.tick.metrics", {"type": "log"})
    before = len(ph.logger.records)
    ph.publish_tick_metrics(pm)
    assert len(ph.logger.records) == before
    for h in (jh, ph):
        h.destroy()
    assert ph.tracers.tracers == {}


def test_tracer_expiry_and_channel_sink_equal_jax(monkeypatch):
    calls = {}
    for name, tap, trace, timers in (("jax", jtap, jtrace, jtimers),
                                     ("port", ptap, ptrace, ptimers)):
        class Channel:
            def __init__(self):
                self.sent = []

            def request(self, host_port, endpoint, head=None, body=None, timeout_s=None):
                if body.get("tick") == 1:
                    raise OSError("down")
                self.sent.append((host_port, endpoint, head, body))

        clock = [1_000_000.0]
        monkeypatch.setattr(trace.time, "time", lambda: clock[0])
        host = tap.SimTracerHost(logger=ListLogger(), timers=timers.FakeTimers(),
                                 channel=Channel())
        spec = {"type": "channel", "hostPort": "10.0.0.9:3000"}
        t = host.tracers.add(trace.Tracer(host, "sim.tick.metrics", spec, expires_in_ms=1500))
        # a duplicate add refreshes the expiry of the one kept
        assert host.tracers.add(trace.Tracer(host, "sim.tick.metrics", spec)) is t
        host.publish_tick_metrics({"pings_sent": np.arange(3, dtype=np.int32)})
        clock[0] += 70.0
        host.timers.advance(1.0)  # the expiry scan: the tracer is past its TTL
        host.publish_tick_metrics({"pings_sent": np.int32(9)}, start_tick=5)
        with pytest.raises(trace.TraceError):
            trace.Tracer(host, "no.such.event", {"type": "log"})
        with pytest.raises(trace.TraceError):
            trace.Tracer(host, "sim.tick.metrics", {"type": "channel"})
        with pytest.raises(trace.TraceError):
            trace.Tracer(object(), "sim.tick.metrics", {"type": "log"})
        calls[name] = (host.channel.sent, host.logger.warnings, dict(host.tracers.tracers))
        host.destroy()
    assert calls["port"][:2] == calls["jax"][:2]
    sent, warnings, alive = calls["port"]
    assert [b["tick"] for _, _, _, b in sent] == [0, 2] and len(warnings) == 1 and not alive


def test_raising_sink_leaves_the_window_on_the_device():
    p = _port_cluster()
    host = ptap.SimTracerHost(p, logger=RaisingLogger(), timers=ptimers.FakeTimers())
    host.tracers.add(ptrace.Tracer(host, "sim.flight.events", {"type": "log"}))
    p.attach_tracer(host)
    p.bootstrap()
    head, drops = int(p.state.ev_head), int(p.state.ev_drops)
    assert head > 0
    with pytest.raises(RuntimeError, match="sink down"):
        p.drain_events()
    assert (int(p.state.ev_head), int(p.state.ev_drops)) == (head, drops)
    host.logger = ListLogger()
    events = p.drain_events()
    assert len(events) == head and int(p.state.ev_head) == 0
    (_, extra), = host.logger.records
    assert extra["blob"]["events"] == events and extra["blob"]["total"] == head
    # and JAX's contract is the same
    j = _jax_cluster()
    jhost = jtap.SimTracerHost(j, logger=RaisingLogger(), timers=jtimers.FakeTimers())
    jhost.tracers.add(jtrace.Tracer(jhost, "sim.flight.events", {"type": "log"}))
    j.attach_tracer(jhost)
    j.bootstrap()
    with pytest.raises(RuntimeError, match="sink down"):
        j.drain_events()
    assert int(np.asarray(j.state.ev_head)) == head
    for h in (host, jhost):
        h.destroy()


@pytest.mark.parametrize("kw", [
    {},
    {"fused_checksum": "on", "fused_tick": "off"},
    {"fused_checksum": "off", "fused_tick": "off", "parity_recompute": "gated"},
])
def test_sim_resolution_stat_equal_jax(kw):
    jcap, pcap = CapturingStatsd(), CapturingStatsd()
    j = JaxSimCluster(n=N, params=je.SimParams(n=N, checksum_mode="farmhash", **kw))
    p = SimCluster(n=N, params=pe.SimParams(n=N, checksum_mode="farmhash", **kw), device="cpu")
    j.emit_resolution_stat(jsb.StatsdBridge(statsd=jcap, host_port="h:1"))
    p.emit_resolution_stat(psb.StatsdBridge(statsd=pcap, host_port="h:1"))
    assert pcap.records == jcap.records
    assert [k for _, k, _ in pcap.records] == [
        "ringpop.h_1.sim.fused_checksum.resolution_differs",
        "ringpop.h_1.sim.fused_tick.resolution_differs"]


@pytest.mark.parametrize("jax_knob,port_knob", [("auto", "auto"), ("xla", "plain")])
def test_scalable_resolution_stat_equal_jax(jax_knob, port_knob):
    jcap, pcap = CapturingStatsd(), CapturingStatsd()
    j = JaxScalable(64, params=jes.ScalableParams(n=64, u=128, fused_exchange=jax_knob))
    p = ScalableCluster(64, params=es.ScalableParams(n=64, u=128, fused_exchange=port_knob),
                        device="cpu")
    j.emit_resolution_stat(jsb.StatsdBridge(statsd=jcap, host_port="h:1"))
    p.emit_resolution_stat(psb.StatsdBridge(statsd=pcap, host_port="h:1"))
    assert pcap.records == jcap.records == [
        ("gauge", "ringpop.h_1.sim.fused_exchange.resolution_differs", 0)]
