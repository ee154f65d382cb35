"""The span log of ``obs/perf.py``: ``span``, ``phases``, ``count`` and
``tracing``, and the spans and counters the drivers and both engines log.

Off (no timer installed) a span is one shared no-op object that reads no
clock; on, spans nest by parent index, a shard body's spans never take
another body's span as their parent, and state and metrics are bitwise
the same as with the log off.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.batched import BatchedSimClusters
from ringpop_tpu_torch.models.sim.cluster import EventSchedule
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.obs import chrome_trace
from ringpop_tpu_torch.obs import perf
from ringpop_tpu_torch.parallel.mesh import ShardedSim, make_mesh

CPU = "cpu"


def _traced(fn):
    """``fn()`` under a fresh span log; returns (its result, the log)."""
    timer = perf.DispatchTimer()
    with perf.tracing(timer):
        out = fn()
    assert perf.active() is None
    return out, timer


def _ancestors(log, i):
    out = []
    while log[i][3] >= 0:
        i = log[i][3]
        out.append(log[i][0])
    return out


def _assert_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        else:
            assert np.array_equal(x, y), f


def test_off_is_one_shared_no_op_that_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with no span log installed")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(time, "time_ns", no_clock)
    assert perf.active() is None
    assert perf.span("a") is perf.span("b") is perf.phases() is perf._NO_SPAN
    with perf.span("a") as s:
        assert s is perf._NO_SPAN
    ph = perf.phases()
    ph.next("x")
    ph.end()
    perf.count("rows", 3)
    # a storm tick logs nothing and reads no clock
    p = es.ScalableParams(n=64, u=192, suspicion_ticks=4)
    sim = ScalableCluster(64, params=p, device=CPU)
    sim.run(StormSchedule.churn_storm(3, 64, fraction=0.1, fail_tick=1))


def test_nesting_parents_and_counters():
    def body():
        with perf.span("outer"):
            with perf.span("inner"):
                perf.count("rows", 2)
            ph = perf.phases()
            ph.next("p0")
            perf.count("rows", 5)
            ph.next("p1")
            with perf.span("wait"):
                pass
            ph.end()
        with perf.span("second"):
            # a phase a raised exception left open is closed by its parent
            with pytest.raises(KeyError):
                with perf.span("around"):
                    perf.phases().next("abandoned")
                    raise KeyError("x")
        return None

    _, timer = _traced(body)
    names = [r[0] for r in timer.log]
    assert names == ["outer", "inner", "p0", "p1", "wait", "second", "around", "abandoned"]
    parents = [r[3] for r in timer.log]
    assert parents == [-1, 0, 0, 0, 3, -1, 5, 6]
    assert all(r[4] is None for r in timer.log)
    assert all(r[1] <= r[2] for r in timer.log)
    # a child lies inside its parent
    for name, t0, t1, parent, _ in timer.log:
        if parent >= 0:
            assert timer.log[parent][1] <= t0 and t1 <= timer.log[parent][2], name
    assert timer.counters == {"rows": 7}
    # the clock is the profiler's: Unix-epoch ns
    assert abs(timer.log[0][1] - time.time_ns()) < 60e9


def test_batched_ensemble_spans_are_neutral_and_count_rows():
    b, n, ticks = 2, 64, 4
    p = engine.SimParams(n=n, checksum_mode="farmhash")
    sched = EventSchedule.churn_window(ticks, n)

    def run():
        sim = BatchedSimClusters(b, n, params=p, seed=7, device=CPU)
        sim.bootstrap()
        return sim, sim.run(sched)

    (off, m_off) = run()
    (on, m_on), timer = _traced(run)
    _assert_equal(off.state, on.state)
    _assert_equal(m_off, m_on)
    log = timer.log
    ticks_on = [i for i, r in enumerate(log) if r[0] == "batched.tick"]
    assert len(ticks_on) == 1 + ticks  # the bootstrap tick and the run's
    for t in ticks_on:
        kids = [i for i, r in enumerate(log) if r[3] == t]
        assert [log[i][0] for i in kids] == [
            "fault", "leave", "join", "target", "piggyback", "delivery", "receive",
            "checksum.mid", "respond", "ping_req", "expiry", "checksum"]
        for site in ("checksum.mid", "checksum"):
            (s,) = [i for i in kids if log[i][0] == site]
            inner = sorted(log[i][0] for i, r in enumerate(log) if r[3] == s)
            assert inner == ["checksum.encode", "checksum.hash"]
    # two sites a tick, every row of every cluster; init_state hashes once
    assert timer.counters["rows_hashed"] == 2 * b * n * (1 + ticks) + b * n
    assert timer.counters["rows_dirty"] == int(m_on.dirty_rows.sum()) > 0
    run_span = [i for i, r in enumerate(log) if r[0] == "batched.run"]
    assert len(run_span) == 1
    reads = [i for i, r in enumerate(log) if r[0] == "batched.metrics_read"]
    assert [log[log[i][3]][0] if log[i][3] >= 0 else None for i in reads] == [None, "batched.run"]
    for i in reads:
        assert [r[0] for r in log if r[3] == i] == ["wait"]


def test_storm_wait_spans_match_the_host_read_counter():
    n = 256
    p = es.ScalableParams(n=n, u=192, suspicion_ticks=5)
    sched = StormSchedule.churn_storm(12, n, fraction=0.1, fail_tick=2, rejoin_tick=7)
    off = ScalableCluster(n, params=p, replica_points=4, device=CPU)
    m_off = off.run(sched)
    d_off = off.ring_checksum()
    on = ScalableCluster(n, params=p, replica_points=4, device=CPU)
    reads0 = es.host_read.count

    def run():
        return on.run(sched), on.ring_checksum()

    (m_on, d_on), timer = _traced(run)
    reads = es.host_read.count - reads0
    _assert_equal(off.state, on.state)
    _assert_equal(m_off, m_on)
    assert d_on == d_off
    log = timer.log
    engine_waits = [i for i, r in enumerate(log)
                    if r[0] == "wait" and "storm.tick" in _ancestors(log, i)]
    assert reads > 0 and len(engine_waits) == reads
    # every wait names its site: a phase, a prp walk or a driver span
    assert {log[log[i][3]][0] for i in engine_waits} <= {
        "fault", "aging", "exchange", "suspect", "expiry", "refute", "leave", "checksum",
        "prp_walk"}
    assert sum(r[0] == "storm.tick" for r in log) == 12
    top = [r[0] for r in log if r[3] == -1]
    assert top == ["storm.run", "storm.ring"]
    (ring,) = [i for i, r in enumerate(log) if r[0] == "storm.ring"]
    assert [r[0] for r in log if r[3] == ring] == ["wait"]
    (read,) = [i for i, r in enumerate(log) if r[0] == "storm.metrics_read"]
    assert [r[0] for r in log if r[3] == read] == ["wait"]
    phases = {r[0] for r in log if r[3] >= 0 and log[r[3]][0] == "storm.tick"}
    assert phases == {"fault", "aging", "exchange", "suspect", "expiry", "refute", "leave",
                      "checksum"}


def test_sharded_sim_spans_stay_in_their_shard():
    n, shards = 32, 2
    p = engine.SimParams(n=n, checksum_mode="fast")
    sched = EventSchedule.churn_window(6, n)

    def run():
        sim = ShardedSim(n, make_mesh(shards, device=CPU), params=p, seed=3)
        sim.bootstrap()
        sim.run(sched)
        return sim

    off = run()
    on, timer = _traced(run)
    _assert_equal(off.state, on.state)
    log = timer.log
    # outside the bodies only the cluster's metrics reads
    assert {r[4] for r in log} == {0, 1, None}
    assert {r[0] for r in log if r[4] is None} == {"wait"}
    for name, _, _, parent, shard in log:
        if parent >= 0:
            assert log[parent][4] in (None, shard), name
    for shard in range(shards):
        assert sum(r[0] == "fault" and r[4] == shard for r in log) == 7  # bootstrap + 6


def test_chrome_trace_events_carry_the_log():
    def run():
        with perf.span("outer"):
            with perf.span("inner"):
                pass

    _, timer = _traced(run)
    with timer.phase("legacy"):
        pass
    events = timer.chrome_trace_events(pid=chrome_trace.HOST_PID)
    assert [e["name"] for e in events] == ["legacy", "outer", "inner"]
    assert events[1]["args"] == {"span": 0, "parent": -1, "shard": None}
    assert events[2]["args"] == {"span": 1, "parent": 0, "shard": None}
    assert events[1]["ts"] <= events[2]["ts"]
    trace = chrome_trace.add_host_timeline({"traceEvents": []}, timer)
    assert chrome_trace.validate_chrome_trace(trace) == []


def test_update_sites_launch_in_their_phase_spans(monkeypatch):
    from ringpop_tpu_torch.ops import fused_apply as fap

    sites = []
    apply_plain = fap.apply_updates_plain

    def noted(*args, **kwargs):
        timer = perf.active()
        sites.append(timer.log[timer._stacks[None][-1]][0])
        return apply_plain(*args, **kwargs)

    monkeypatch.setattr(fap, "apply_updates_plain", noted)
    n, ticks = 16, 5
    sim = BatchedSimClusters(2, n, params=engine.SimParams(n=n, checksum_mode="farmhash"),
                             device=CPU)
    _traced(lambda: sim.run(EventSchedule.churn_window(ticks, n)))
    # six update sites a tick, each inside its phase's span
    assert sorted(set(sites)) == ["expiry", "ping_req", "receive", "respond"]
    assert len(sites) == 6 * ticks
