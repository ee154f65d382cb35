"""The port's statsd bridge (obs/statsd_bridge.py) against the JAX one.

Each bridge writes to its own capturing client; fed the same input, they
must make the same (type, key, value) calls in the same order.  The
inputs: ``TickMetrics``, ``ScalableMetrics`` and ``RouteMetrics`` series
from port runs (numpy for JAX, and the port's tensor NamedTuples for the
port, read to the host in one transfer), single rows with ``[B]`` batch
vectors, histogram summaries, exchange and request-trace drain rows, SLO
rows, a resolution note, and the ``ringpop=`` facade path.  Then each
wired ``statsd=`` sink — the three drivers' histogram drains,
``ScalableCluster.drain_exchange_metrics``, ``RoutedStorm.drain_requests``,
``toolkit.emit_resolution`` and the recovery plane's counters — against the
JAX host function or manager on the same data.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.recovery import CheckpointManager as JaxManager
from ringpop_tpu.models.sim.recovery import CheckpointSpec as JaxSpec
from ringpop_tpu.obs import exchange_stats as jxs
from ringpop_tpu.obs import histograms as joh
from ringpop_tpu.obs import requests as joreq
from ringpop_tpu.obs import statsd_bridge as jsb
from ringpop_tpu.ops import toolkit as jtk
from ringpop_tpu.utils.stats import CapturingStatsd
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.route import plane as pplane
from ringpop_tpu_torch.models.sim import checkpoint as pck
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.models.sim.recovery import CheckpointManager, CheckpointSpec
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.obs import statsd_bridge as psb
from ringpop_tpu_torch.ops import toolkit as ptk
from ringpop_tpu_torch.ops import u32

HOST = "10.0.0.7:3001"


def _pair(host_port=HOST):
    jcap, pcap = CapturingStatsd(), CapturingStatsd()
    return (jsb.StatsdBridge(statsd=jcap, host_port=host_port), jcap,
            psb.StatsdBridge(statsd=pcap, host_port=host_port), pcap)


def _tensors(metrics):
    return type(metrics)(*(torch.as_tensor(np.asarray(x)) for x in metrics))


def _sim_series():
    sim = SimCluster(n=16, params=pe.SimParams(n=16, checksum_mode="fast"), seed=2, device="cpu")
    sim.bootstrap()
    return sim.run(EventSchedule.churn_window(12, 16))


def _storm_series():
    c = ScalableCluster(n=64, params=es.ScalableParams(n=64, u=192, suspicion_ticks=4,
                                                      enable_leave=True), seed=1, device="cpu")
    return c.run(StormSchedule.churn_storm(14, 64, fraction=0.1, fail_tick=1, rejoin_tick=7))


def _route_series():
    rs = pplane.RoutedStorm(64, params=es.ScalableParams(n=64, u=192, suspicion_ticks=4),
                            route=pplane.RouteParams(n=64, queries_per_tick=256, key_space=1024),
                            seed=1, device="cpu")
    return rs.run(StormSchedule.churn_storm(10, 64, fraction=0.1, fail_tick=1, rejoin_tick=5))


def test_key_maps_and_prefix_equal_jax():
    for name in ("TICK_KEY_MAP", "PERF_TIMER_KEYS", "HIST_TIMER_KEYS", "EXCHANGE_KEY_MAP",
                 "EXCHANGE_HIST_KEYS", "XPROF_KEY_MAP", "REQTRACE_KEY_MAP", "SLO_KEY_MAP",
                 "SLO_BREACH_KEY", "CKPT_KEY_MAP"):
        assert getattr(psb, name) == getattr(jsb, name), name
    for hp in (HOST, "127.0.0.1:3000", "host.example:9"):
        assert psb.stat_prefix(hp) == jsb.stat_prefix(hp)
    with pytest.raises(ValueError):
        psb.StatsdBridge()
    with pytest.raises(ValueError):
        psb.StatsdBridge(statsd=CapturingStatsd())


@pytest.mark.parametrize("series", ["sim", "storm", "route"])
@pytest.mark.parametrize("form", ["numpy", "tensors"])
def test_emit_series_equal_jax(series, form):
    metrics = {"sim": _sim_series, "storm": _storm_series, "route": _route_series}[series]()
    parts = metrics if isinstance(metrics, tuple) and not hasattr(metrics, "_fields") else (metrics,)
    jb, jcap, pb, pcap = _pair()
    for m in parts:
        assert pb.emit_series(_tensors(m) if form == "tensors" else m) == jb.emit_series(m)
    assert pcap.records == jcap.records and pcap.records


def test_emit_tick_rows_and_batch_vectors_equal_jax():
    jb, jcap, pb, pcap = _pair()
    rows = [
        {"pings_sent": 12, "ping_reqs": 3, "refutes": 1, "distinct_checksums": 4,
         "converged": False, "mean_heard_frac": 0.25},
        {"pings_sent": np.int32(0), "live_nodes": np.int32(7), "parity_overflow": True},
    ]
    for row in rows:
        assert pb.emit_tick(row) == jb.emit_tick(row)
    # a port row of 0-d tensors, and [T, B] vmapped series
    trow = {"pings_sent": torch.tensor(5, dtype=torch.int32),
            "distinct_checksums": torch.tensor(2, dtype=torch.int32)}
    assert pb.emit_tick(trow) == jb.emit_tick({k: v.numpy() for k, v in trow.items()})
    series = {"pings_sent": np.asarray([[3, 4], [5, 6]]),
              "distinct_checksums": np.asarray([[2, 2], [1, 1]])}
    assert pb.emit_series({k: torch.as_tensor(v) for k, v in series.items()}) == \
        jb.emit_series(series) == 2
    assert pcap.records == jcap.records


def test_drain_rows_summaries_and_direct_calls_equal_jax():
    from ringpop_tpu_torch.obs import histograms as poh

    rng = np.random.default_rng(3)
    hist = rng.integers(0, 40, (3, 32)).astype(np.uint32)
    hist[1] = 0
    jb, jcap, pb, pcap = _pair()
    summary = poh.summarize(u32.from_numpy(hist), ("rumor_age", "retry_depth", "odd_track"))
    assert summary == joh.summarize(hist, ("rumor_age", "retry_depth", "odd_track"))
    assert pb.emit_hist_summary(summary) == jb.emit_hist_summary(summary)
    tot = {"shards": 4, "ticks": 9, "a2a_pull": 0, "a2a_push": 3, "wire_bytes_pull": 10 ** 9}
    assert pb.emit_exchange_drain(tot) == jb.emit_exchange_drain(tot)
    row = {"source": "route", "records": 5, "drops": 0, "cap": 64, "sample_log2": 2,
           "counts": {"queries": 9, "misroutes": 0, "reroute_local": 2}}
    assert pb.emit_reqtrace_drain(row) == jb.emit_reqtrace_drain(row)
    slo = {"target": "route-p99", "p50": 1.0, "p95": None, "p99": 4.0, "success_rate": 0.99,
           "burn_rate": 2.5, "queries": 100, "errors": 0}
    assert pb.emit_slo_window(slo) == jb.emit_slo_window(slo)
    pb.emit_slo_breach("route-p99")
    jb.emit_slo_breach("route-p99")
    for b in (pb, jb):
        b.increment("sim.x", 3)
        b.gauge("sim.g", 1.5)
        b.timing("sim.t", 7)
    assert pcap.records == jcap.records and len(pcap.records) > 10


def test_facade_path_equal_jax():
    class Facade:
        def __init__(self):
            self.calls = []

        def stat(self, stat_type, key, value=None):
            self.calls.append((stat_type, key, value))

    jf, pf = Facade(), Facade()
    m = _storm_series()
    jsb.StatsdBridge(ringpop=jf).emit_series(m)
    psb.StatsdBridge(ringpop=pf).emit_series(_tensors(m))
    assert pf.calls == jf.calls and pf.calls


def test_emit_resolution_sink_equal_jax():
    jb, jcap, pb, pcap = _pair()
    for req, res, cap in (("auto", "plain", None), ("auto", "kernel", 7), ("kernel", "kernel", 3)):
        jnote = jtk.resolution_note("fused_exchange", req, res, "cpu", "xla", cap=cap)
        pnote = ptk.resolution_note("fused_exchange", req, res, "cpu", "xla", cap=cap)
        assert pnote == jnote
        jtk.emit_resolution(jnote, statsd=jb, gauge_prefix="sim.fused_exchange")
        ptk.emit_resolution(pnote, statsd=pb, gauge_prefix="sim.fused_exchange")
        # without a prefix the statsd sink stays silent, as in JAX
        ptk.emit_resolution(pnote, statsd=pb)
    assert pcap.records == jcap.records and len(pcap.records) == 5


def test_driver_drain_sinks_equal_jax():
    """Each driver's wired sink emits what the JAX host drain emits on the
    same counters."""
    from ringpop_tpu_torch.obs import requests as poreq

    jb, jcap, pb, pcap = _pair()
    sim = SimCluster(n=16, params=pe.SimParams(n=16, checksum_mode="fast", histograms=True),
                     seed=2, device="cpu")
    sim.bootstrap()
    sim.run(EventSchedule.churn_window(12, 16))
    hist = u32.to_numpy(sim.state.hist)
    sim.drain_histograms(statsd=pb)
    joh.drain(hist, pe.HIST_TRACKS, "sim.engine", statsd=jb)

    st = ScalableCluster(n=64, params=es.ScalableParams(n=64, u=192, suspicion_ticks=4,
                                                       histograms=True, exchange_metrics=4),
                         seed=1, device="cpu")
    st.run(StormSchedule.churn_storm(12, 64, fraction=0.1, fail_tick=1, rejoin_tick=6))
    hist = u32.to_numpy(st.state.hist)
    exch, exch_hist = u32.to_numpy(st.state.exch), u32.to_numpy(st.state.exch_hist)
    st.drain_histograms(statsd=pb)
    joh.drain(hist, es.SCALABLE_HIST_TRACKS, "sim.engine_scalable", statsd=jb)
    st.drain_exchange_metrics(statsd=pb)
    jxs.drain(exch, exch_hist, w=int(st.state.heard.shape[1]), local_rows=16,
              source="sim.engine_scalable", statsd=jb)

    rs = pplane.RoutedStorm(64, params=es.ScalableParams(n=64, u=192, suspicion_ticks=4),
                            route=pplane.RouteParams(n=64, queries_per_tick=256, key_space=1024,
                                                     histograms=True, reqtrace=True,
                                                     req_capacity=512, req_sample_log2=1),
                            seed=1, device="cpu")
    rs.run(StormSchedule.churn_storm(8, 64, fraction=0.1, fail_tick=1, rejoin_tick=4))
    r = rs.rstate
    rhist = u32.to_numpy(r.hist)
    req = [t.numpy().copy() for t in (r.req_buf, r.req_head, r.req_drops, r.req_counts)]
    rs.drain_histograms(statsd=pb)
    joh.drain(rhist, pplane.ROUTE_HIST_TRACKS, "route", statsd=jb)
    rs.drain_requests(statsd=pb)
    joreq.drain(*req, sample_log2=1, source="route", statsd=jb)
    assert poreq.COUNT_FIELDS == joreq.COUNT_FIELDS
    assert pcap.records == jcap.records and len(pcap.records) > 20


def test_recovery_counters_equal_jax(tmp_path):
    """The recovery plane's ``ckpt.*`` counters through the bridge: the
    port's manager and the JAX one, each saving the same state three
    times (keep=2), the newest torn, then a restore."""
    import os

    jb, jcap, pb, pcap = _pair()
    params = es.ScalableParams(n=16, u=160, suspicion_ticks=4)
    state = es.init_state(params, seed=2, device="cpu")
    jstate = jes.ScalableState(**convert.state_arrays(state))
    jparams = jes.ScalableParams(**convert.params_to_jax_fields(params))
    managers = (
        CheckpointManager(str(tmp_path / "p"), CheckpointSpec(es.ScalableState, params),
                          keep=2, statsd=pb),
        JaxManager(str(tmp_path / "j"), JaxSpec(jes.ScalableState, jparams), keep=2, statsd=jb),
    )
    for mgr, st in zip(managers, (state, jstate)):
        for t in (2, 4, 6):
            path = mgr.save(t, st)
        mpath = os.path.join(path, pck.MANIFEST_NAME)
        with open(mpath, "r+b") as fh:
            fh.truncate(os.path.getsize(mpath) // 2)
        assert mgr.restore_latest()[0] == 4
    assert pcap.records == jcap.records
    keys = [r[1].rsplit(".", 1)[-1] for r in pcap.records]
    assert keys.count("saved") == 3 and "gc" in keys and "corrupt" in keys and "resumed" in keys
