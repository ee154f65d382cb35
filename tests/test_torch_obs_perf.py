"""The port's dispatch timers (``obs/perf.py``), host-timeline merge
(``obs/chrome_trace.add_host_timeline``) and adaptive-period host twins
(``obs/histograms.py``) against the JAX package's, on the same inputs.

Both packages' timers read one injected fake clock, so every row, span and
statsd sample must be equal; only the measured wall a ``timed_window``
returns reads the real clock.  ``wrap_cluster`` must leave a port driver's
run bitwise the unwrapped run, time its public ``step``/``run`` under
JAX's phase names, and stay idempotent.  Tolerance: none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.models.route.plane import RoutedStorm as JaxRouted
from ringpop_tpu.models.route.plane import RouteParams as JaxRouteParams
from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.batched import BatchedSimClusters as JaxBatched
from ringpop_tpu.models.sim.cluster import SimCluster as JaxSimCluster
from ringpop_tpu.models.sim.storm import ScalableCluster as JaxScalable
from ringpop_tpu.obs import chrome_trace as jct
from ringpop_tpu.obs import histograms as joh
from ringpop_tpu.obs import perf as jperf
from ringpop_tpu.obs import statsd_bridge as jsb
from ringpop_tpu.parallel import mesh as jmesh
from ringpop_tpu.utils.stats import CapturingStatsd
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.route.plane import RoutedStorm, RouteParams
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.batched import BatchedSimClusters
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.obs import chrome_trace as pct
from ringpop_tpu_torch.obs import histograms as poh
from ringpop_tpu_torch.obs import perf as pperf
from ringpop_tpu_torch.obs import statsd_bridge as psb
from ringpop_tpu_torch.parallel import mesh as pmesh
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _clock(seed: int, count: int = 512):
    """A monotone fake clock from a seeded sequence of increments."""
    steps = np.random.default_rng(seed).integers(1, 5000, size=count) * 1e-6
    it = iter((100.0 + np.cumsum(steps)).tolist())
    return lambda: next(it)


class _Rows:
    """A recorder stand-in keeping every ``record_event`` row."""

    def __init__(self):
        self.rows = []

    def record_event(self, name, **fields):
        self.rows.append((name, fields))


def _drive(perf, seed):
    """One timer of ``perf``'s package through wrapped calls and spans."""
    timer = perf.DispatchTimer(clock=_clock(seed))
    tick = timer.wrap("tick", lambda x: x + 1)
    scan = timer.wrap("scan", lambda x: np.arange(x))
    for i in range(7):
        tick(np.int32(i))
    for i in range(3):
        scan(i + 2)
        with timer.phase("checksum"):
            pass
    return timer


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentiles_exact_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for size in (0, 1, 7, 100, 1001):
        walls = rng.exponential(0.004, size=size).tolist()
        for qs in ((50, 95, 99), (1, 25, 50, 75, 99.9, 100)):
            assert pperf.percentiles_exact(walls, qs) == jperf.percentiles_exact(walls, qs)


@pytest.mark.parametrize("seed", [0, 5])
def test_dispatch_timer_equal_jax(seed):
    jt, pt = _drive(jperf, seed), _drive(pperf, seed)
    assert pt.summary() == jt.summary()
    assert pt.summary((10, 90)) == jt.summary((10, 90))
    # no jit cache in the port: nothing compiled, nothing a cache hit
    assert all(r["compile_calls"] == 0 and r["cache_hits"] == 0 for r in pt.summary())
    jrows, prows = _Rows(), _Rows()
    assert pt.emit(prows, run="x") == jt.emit(jrows, run="x") == 3
    assert prows.rows == jrows.rows
    assert pt.chrome_trace_events(pid=3, tid=1) == jt.chrome_trace_events(pid=3, tid=1)
    for phase in ("tick", "scan", "absent"):
        for floor in (0.0, 0.01, 200.0):
            assert pt.protocol_delay_ms(phase, floor) == jt.protocol_delay_ms(phase, floor)
    jcap, pcap = CapturingStatsd(), CapturingStatsd()
    assert (pt.emit_statsd(psb.StatsdBridge(statsd=pcap, host_port="10.0.0.1:3000"))
            == jt.emit_statsd(jsb.StatsdBridge(statsd=jcap, host_port="10.0.0.1:3000")))
    assert pcap.records == jcap.records and pcap.records


def test_timed_window_rows_equal_jax():
    out = {}
    for name, perf in (("jax", jperf), ("port", pperf)):
        calls = []

        def run():
            calls.append(1)
            return np.full(4, len(calls))

        rows = _Rows()
        timer = perf.DispatchTimer(clock=_clock(9))
        res, wall = perf.timed_window(run, warmup=2, repeats=3, recorder=rows,
                                      phase="bench", timer=timer, n=4)
        assert wall > 0 and len(calls) == 5 and (res == 5).all()
        out[name] = rows.rows, timer.summary(), timer.chrome_trace_events()
    assert out["port"] == out["jax"]
    (name, row), = out["port"][0]
    assert name == "perf.phase" and row["calls"] == 3 and row["n"] == 4


def test_stopwatch_accumulates():
    sink = {}
    for _ in range(3):
        with pperf.stopwatch(sink, "host"):
            pass
    with pytest.raises(KeyError):
        with pperf.stopwatch(sink, "raised"):
            raise KeyError("x")
    assert set(sink) == {"host", "raised"} and all(v >= 0 for v in sink.values())


def test_fence_is_the_identity_off_the_card():
    x = torch.arange(6)
    tree = {"a": (x, [np.ones(2), 3]), "b": None}
    assert pperf.fence(tree) is tree
    arr = np.zeros(3)
    assert pperf.fence(arr) is arr
    assert list(pperf._tensors(tree)) == [x]


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_fence_syncs_every_card_of_the_outputs(two_cards, monkeypatch):
    a = torch.ones(1 << 20, device="cuda:0")
    b = torch.ones(1 << 20, device="cuda:1")
    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: (synced.append(d), real(d)))
    tree = (a * 2, {"other": [b + 1, b * 3]}, np.zeros(2))
    assert pperf.fence(tree) is tree
    assert synced == [torch.device("cuda:0"), torch.device("cuda:1")]


def test_add_host_timeline_equal_jax():
    sim = SimCluster(n=16, params=pe.SimParams(n=16, checksum_mode="fast", flight_recorder=True,
                                               event_capacity=4096), seed=4, device="cpu")
    sim.bootstrap()
    sim.drain_events()
    sim.run(EventSchedule.churn_window(12, 16))
    events = sim.drain_events()
    traces = []
    for ct, perf in ((jct, jperf), (pct, pperf)):
        trace = ct.export_chrome_trace(events, n=16, period_ms=sim.params.period_ms)
        trace["otherData"].pop("generator")
        got = ct.add_host_timeline(trace, _drive(perf, 3), label="dispatch")
        assert got is trace and ct.validate_chrome_trace(trace) == []
        traces.append(trace)
    assert traces[1] == traces[0]
    assert pct.HOST_PID == jct.HOST_PID
    host = [e for e in traces[1]["traceEvents"] if e["pid"] == pct.HOST_PID]
    assert host[0]["name"] == "process_name" and len(host) == 1 + 7 + 3 + 3


def test_protocol_delay_and_host_twins_equal_jax():
    for p50 in (None, 0.0, 12.5, 99.9, 100.0, 400.0):
        for floor in (0.0, 200.0):
            assert poh.compute_protocol_delay(p50, floor) == joh.compute_protocol_delay(p50, floor)
    rng = np.random.default_rng(11)
    lat = np.concatenate([rng.exponential(30.0, 200), [0.0, -1.0, 1e9]]).tolist()
    for unit in (1.0, 1e-4, 0.25):
        jh, ph = joh.HostHistogram(unit=unit), poh.HostHistogram(unit=unit)
        for v in lat:
            jh.observe(v)
            ph.observe(v)
        assert np.array_equal(ph.counts, jh.counts)
        assert ph.summary() == jh.summary() and ph.summary((10, 99.9)) == jh.summary((10, 99.9))
    with pytest.raises(ValueError):
        poh.HostHistogram(unit=0)
    ja, pa = joh.AdaptiveProtocolPeriod(150.0, 0.5), poh.AdaptiveProtocolPeriod(150.0, 0.5)
    assert pa.period_ms() == ja.period_ms() == 150.0 and pa.p50_ms() is None
    for v in lat:
        ja.observe(v)
        pa.observe(v)
        assert (pa.p50_ms(), pa.period_ms()) == (ja.p50_ms(), ja.period_ms())


def _state_np(state):
    return convert.state_to_numpy(state)


def test_wrap_cluster_bitwise_and_idempotent():
    p = pe.SimParams(n=16, checksum_mode="farmhash", flight_recorder=True, histograms=True,
                     event_capacity=4096)
    runs = []
    for wrapped in (False, True):
        c = SimCluster(n=16, params=p, seed=5, device="cpu")
        timer = pperf.wrap_cluster(c) if wrapped else None
        m0 = c.bootstrap()
        m = c.run(EventSchedule.churn_window(10, 16))
        runs.append((c, timer, m0, m))
    (a, _, a0, am), (b, timer, b0, bm) = runs
    sa, sb = _state_np(a.state), _state_np(b.state)
    assert sa.keys() == sb.keys()
    for f in sa:
        assert np.array_equal(sa[f], sb[f]), f
    for x, y in ((a0, b0), (am, bm)):
        for f in pe.TickMetrics._fields:
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
    assert timer.phases["tick"].calls == 1  # the bootstrap's step
    assert timer.phases["scan"].calls == 1
    assert a.drain_events() == b.drain_events()
    # idempotent: a re-wrap without a timer returns the bound one, and an
    # explicit timer does not wrap twice
    assert pperf.wrap_cluster(b) is timer
    other = pperf.DispatchTimer()
    assert pperf.wrap_cluster(b, other) is other
    assert b.step.__name__ == "timed_tick" and b.run.__name__ == "timed_scan"
    assert not getattr(b.step.__wrapped__, "__perf_timed__", False)
    assert b.step.__perf_timer__ is timer
    # the fault keys and run_until_converged go through the timed step
    b.kill([3])
    assert timer.phases["tick"].calls == 2 and not other.phases


def _jax_phases(c):
    """The phases JAX's wrap_cluster times on a JAX driver."""
    jperf.wrap_cluster(c)
    out = set()
    for attr in ("_tick", "_scanned", "_scan", "step", "run"):
        fn = getattr(c, attr, None)
        if fn is not None and getattr(fn, "__perf_timed__", False):
            out.add(fn.__name__[len("timed_"):])
    return out


def _sim_case():
    jax_c = JaxSimCluster(n=16, params=je.SimParams(n=16, checksum_mode="fast"))
    port_c = SimCluster(n=16, params=pe.SimParams(n=16, checksum_mode="fast"), device="cpu")
    return jax_c, port_c, lambda c: (c.bootstrap(), c.run(EventSchedule(ticks=2, n=16)))


def _batched_case():
    jax_c = JaxBatched(2, 16, params=je.SimParams(n=16, checksum_mode="fast"))
    port_c = BatchedSimClusters(2, 16, params=pe.SimParams(n=16, checksum_mode="fast"),
                                device="cpu")
    return jax_c, port_c, lambda c: (c.bootstrap(), c.run(EventSchedule(ticks=2, n=16)))


def _scalable_case():
    jax_c = JaxScalable(64, params=jes.ScalableParams(n=64, u=128))
    port_c = ScalableCluster(64, params=es.ScalableParams(n=64, u=128), device="cpu")
    return jax_c, port_c, lambda c: (c.step(), c.run(StormSchedule(ticks=2, n=64)))


def _routed_case():
    jax_c = JaxRouted(64, params=jes.ScalableParams(n=64, u=128),
                      route=JaxRouteParams(n=64, queries_per_tick=64, key_space=256))
    port_c = RoutedStorm(64, params=es.ScalableParams(n=64, u=128),
                         route=RouteParams(n=64, queries_per_tick=64, key_space=256),
                         device="cpu")
    return jax_c, port_c, lambda c: (c.step(), c.run(StormSchedule(ticks=2, n=64)))


def _sharded_sim_case():
    jax_c = jmesh.ShardedSim(16, mesh=jmesh.make_mesh(1),
                             params=je.SimParams(n=16, checksum_mode="fast"))
    port_c = pmesh.ShardedSim(16, mesh=pmesh.make_mesh(2, device="cpu"),
                              params=pe.SimParams(n=16, checksum_mode="fast"))
    return jax_c, port_c, lambda c: (c.bootstrap(), c.run(EventSchedule(ticks=2, n=16)))


def _sharded_storm_case():
    jax_c = jmesh.ShardedStorm(16, mesh=jmesh.make_mesh(1), params=jes.ScalableParams(n=16, u=128))
    port_c = pmesh.ShardedStorm(16, mesh=pmesh.make_mesh(2, device="cpu"),
                                params=es.ScalableParams(n=16, u=128))
    return jax_c, port_c, lambda c: (c.step(), c.run(StormSchedule(ticks=2, n=16)))


@pytest.mark.parametrize("case", [_sim_case, _batched_case, _scalable_case, _routed_case,
                                  _sharded_sim_case, _sharded_storm_case],
                         ids=lambda f: f.__name__[1:-5])
def test_phase_names_on_each_driver(case):
    jax_c, port_c, drive = case()
    timer = pperf.wrap_cluster(port_c)
    drive(port_c)
    assert set(timer.phases) == _jax_phases(jax_c)
    assert timer.phases["scan"].calls == 1
    # only the public entry points are wrapped; a window's ticks stay untimed
    assert not getattr(getattr(port_c, "_tick", None), "__perf_timed__", False)
    if "tick" in timer.phases:
        assert timer.phases["tick"].calls == 1
