"""The port's host copies of the obs modules against the JAX package's, on
the same inputs: ``obs/events.py`` (decoders, reconcile, wavefronts,
summaries, stream validation), ``obs/chrome_trace.py``,
``obs/histograms.py``, ``obs/exchange_stats.py``, ``obs/recorder.py``
(with ``utils/stats.py``'s Meter and Histogram) and the toolkit's
resolution note.  The event streams are a real JAX flight-recorder run.
A run log the port wrote must pass the JAX package's ``validate_run_log``
and read back the same.  Tolerance: none.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.models.sim.cluster import EventSchedule as JaxSchedule
from ringpop_tpu.models.sim.cluster import SimCluster as JaxSimCluster
from ringpop_tpu.obs import chrome_trace as jct
from ringpop_tpu.obs import events as jev
from ringpop_tpu.obs import exchange_stats as jxs
from ringpop_tpu.obs import histograms as joh
from ringpop_tpu.obs import recorder as jrec
from ringpop_tpu.ops import toolkit as jtk
from ringpop_tpu.utils import stats as jstats
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.obs import chrome_trace as pct
from ringpop_tpu_torch.obs import events as pev
from ringpop_tpu_torch.obs import exchange_stats as pxs
from ringpop_tpu_torch.obs import histograms as poh
from ringpop_tpu_torch.obs import recorder as prec
from ringpop_tpu_torch.ops import toolkit as ptk
from ringpop_tpu_torch.ops import u32
from ringpop_tpu_torch.utils import stats as pstats


@pytest.fixture(scope="module")
def flight_run():
    """(events, buffer, head, metrics) of a 24-tick churn window at n=16."""
    sim = JaxSimCluster(n=16, params=je.SimParams(
        n=16, checksum_mode="fast", suspicion_ticks=6, flight_recorder=True,
        fused_tick="xla", event_capacity=4096), seed=4)
    sim.bootstrap()
    sim.drain_events()  # align the buffer with the window's metrics
    metrics = sim.run(JaxSchedule.churn_window(24, 16))
    buf, head = np.asarray(sim.state.ev_buf), int(sim.state.ev_head)
    return sim.drain_events(reset=False), buf, head, metrics


def test_event_registry_equal_jax():
    for name in ("RECORD_WIDTH", "FIELDS", "EVENT_KINDS", "KIND_CODES", "PHASE_PING_RECV",
                 "PHASE_RESPONSE", "PHASE_PING_REQ", "PHASE_JOIN", "PHASE_EXPIRY",
                 "PHASE_ADMIN", "EV_PING", "EV_STATUS", "EV_SUSPECT", "EV_FAULTY",
                 "EV_FULL_SYNC", "EV_REFUTE", "EV_JOIN", "F_TICK", "F_AUX"):
        assert getattr(pev, name) == getattr(jev, name), name


def test_decoders_equal_jax(flight_run):
    events, buf, head, _ = flight_run
    for h, drops in ((head, 0), (head // 2, 3), (0, 0)):
        a, b = pev.decode_arrays(buf, h), jev.decode_arrays(buf, h)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        assert pev.decode_events(buf, h, drops) == jev.decode_events(buf, h, drops)
    assert pev.decode_events(buf, head) == events
    with pytest.raises(ValueError):
        pev.decode_arrays(buf[:, :5], 1)


def test_reconcile_and_wavefronts_equal_jax(flight_run):
    events, buf, head, metrics = flight_run
    rec = pev.reconcile(events, metrics)
    assert rec == jev.reconcile(events, metrics) and all(v["match"] for v in rec.values())
    assert pev.reconcile((buf, head), metrics) == rec
    wf = pev.rumor_wavefronts(events)
    assert wf == jev.rumor_wavefronts(events) and wf
    for k in (1, 2, 5):
        assert pev.dissemination_summary(wf, k) == jev.dissemination_summary(wf, k)
    assert pev.validate_event_stream(events) == jev.validate_event_stream(events) == []
    bad = [dict(events[0], kind=99), {"tick": 1}, "x", dict(events[-1], tick=-1)]
    assert pev.validate_event_stream(bad) == jev.validate_event_stream(bad)


def test_scalable_wavefront_summary_equal_jax():
    rng = np.random.default_rng(3)
    fh = rng.integers(-1, 30, (50, 64)).astype(np.int32)
    birth = rng.integers(0, 20, 64).astype(np.int32)
    active = rng.random(64) < 0.5
    live = rng.random(50) < 0.9
    for lv in (None, live):
        assert (pev.scalable_wavefront_summary(fh, birth, active, lv)
                == jev.scalable_wavefront_summary(fh, birth, active, lv))


def test_chrome_trace_equal_jax(flight_run, tmp_path):
    events = flight_run[0]
    addrs = ["127.0.0.1:%d" % (3000 + i) for i in range(16)]
    for pings in (False, True):
        got = pct.export_chrome_trace(events, n=16, period_ms=200, addresses=addrs,
                                      include_pings=pings)
        want = jct.export_chrome_trace(events, n=16, period_ms=200, addresses=addrs,
                                       include_pings=pings)
        assert got["otherData"].pop("generator") == "ringpop_tpu_torch.obs.chrome_trace"
        want["otherData"].pop("generator")
        assert got == want
        assert pct.validate_chrome_trace(got) == jct.validate_chrome_trace(got) == []
    bad = {"traceEvents": [{"ph": "Q"}]}
    assert pct.validate_chrome_trace(bad) == jct.validate_chrome_trace(bad) != []
    path = pct.write_chrome_trace(got, str(tmp_path / "t.json"))
    with open(path) as f:
        assert json.load(f) == got


def _bridges():
    """A JAX and a port statsd bridge, each over its own capturing client."""
    from ringpop_tpu.obs.statsd_bridge import StatsdBridge as JaxBridge
    from ringpop_tpu_torch.obs.statsd_bridge import StatsdBridge

    jcap, pcap = jstats.CapturingStatsd(), jstats.CapturingStatsd()
    return (JaxBridge(statsd=jcap, host_port="10.0.0.1:3000"), jcap,
            StatsdBridge(statsd=pcap, host_port="10.0.0.1:3000"), pcap)


def test_histogram_summaries_equal_jax():
    rng = np.random.default_rng(5)
    hist = rng.integers(0, 50, (4, 32)).astype(np.uint32)
    hist[1] = 0  # an empty track
    hist[2, 31] = 2**32 - 1  # the top bucket, a counter past int32
    names = ("a", "b", "c", "d")
    assert poh.summarize(hist, names) == joh.summarize(hist, names)
    # the port's device counters are int32 bit patterns
    assert poh.summarize(u32.from_numpy(hist), names) == joh.summarize(hist, names)
    for q in (1, 50, 99.9, 100):
        for row in hist:
            assert poh.percentile(row, q) == joh.percentile(row, q)
            assert poh.percentile_bucket(row, q) == joh.percentile_bucket(row, q)
    batched = rng.integers(0, 9, (3, 2, 32)).astype(np.uint32)
    for agg in (True, False):
        assert (poh.summarize_batched(batched, ("x", "y"), aggregate=agg)
                == joh.summarize_batched(batched, ("x", "y"), aggregate=agg))
    assert poh.drain_row("s", {"a": 1}, k=2) == joh.drain_row("s", {"a": 1}, k=2)
    with pytest.raises(ValueError):
        poh.summarize(hist, names[:2])
    with pytest.raises(ValueError):
        poh.percentile(hist[0], 0)
    jb, jcap, pb, pcap = _bridges()
    assert poh.drain(u32.from_numpy(hist), names, "s", statsd=pb) == joh.drain(
        hist, names, "s", statsd=jb)
    assert pcap.records == jcap.records and pcap.records


def test_exchange_drain_equal_jax():
    rng = np.random.default_rng(8)
    counters = rng.integers(0, 1000, (4, 9)).astype(np.uint32)
    counters[:, 0] = 60
    hist = rng.integers(0, 5, (4, 2, 32)).astype(np.uint32)
    want = jxs.drain(counters, hist, w=16, local_rows=250_000, source="s")
    assert pxs.drain(counters, hist, w=16, local_rows=250_000, source="s") == want
    got = pxs.drain(u32.from_numpy(counters), u32.from_numpy(hist), w=16, local_rows=250_000,
                    source="s")
    assert got == want
    assert pxs.drain(counters, None, w=16, local_rows=250_000, source="s", cap=9) == jxs.drain(
        counters, None, w=16, local_rows=250_000, source="s", cap=9)
    tot = pxs.totals([])
    assert tot == jxs.totals([])
    jb, jcap, pb, pcap = _bridges()
    pxs.drain(counters, hist, w=16, local_rows=250_000, source="s", statsd=pb)
    jxs.drain(counters, hist, w=16, local_rows=250_000, source="s", statsd=jb)
    assert pcap.records == jcap.records and pcap.records


def test_resolution_note_equal_jax():
    for req, res in (("auto", "plain"), ("kernel", "kernel")):
        for sdr in (None, "kernel"):
            assert (ptk.resolution_note("fused_tick", req, res, "cpu", sdr, cap=3)
                    == jtk.resolution_note("fused_tick", req, res, "cpu", sdr, cap=3))


def test_stats_primitives_equal_jax():
    clock = iter(np.arange(0, 100, 0.5)).__next__
    jclock = iter(np.arange(0, 100, 0.5)).__next__
    ph, jh = pstats.Histogram(size=8, rng=random.Random(1)), jstats.Histogram(
        size=8, rng=random.Random(1))
    pm, jm = pstats.Meter(now=clock), jstats.Meter(now=jclock)
    for v in np.random.default_rng(1).integers(0, 100, 40):
        ph.update(float(v))
        jh.update(float(v))
        pm.mark(int(v))
        jm.mark(int(v))
    assert ph.to_dict() == jh.to_dict()
    assert pm.to_dict() == jm.to_dict()


def test_port_run_log_passes_the_jax_validator(tmp_path):
    """A log the port wrote (bootstrap, a window, a drain, a trace
    sidecar) is valid to both packages and reads back the same."""
    path = str(tmp_path / "port.runlog.jsonl")
    rec = prec.RunRecorder(path, run_id="r", stride=3)
    sim = SimCluster(n=12, params=pe.SimParams(n=12, checksum_mode="fast", flight_recorder=True,
                                               histograms=True), device="cpu")
    sim.attach_recorder(rec)
    sim.bootstrap()
    sim.run(EventSchedule.churn_window(10, 12))
    sim.drain_histograms()
    with rec.phase("export"):
        rec.record_trace_sidecar(sim.export_flight_trace())
    rec.finish(note="done")
    assert prec.validate_run_log(path) == [] and jrec.validate_run_log(path) == []
    log = prec.read_run_log(path)
    assert log == jrec.read_run_log(path)
    assert log["header"]["config"]["engine"] == "sim.engine"
    prov = log["header"]["provenance"]
    assert prov["platform"] == "cpu" and prov["torch_version"] == torch.__version__
    names = [e["name"] for e in log["events"]]
    assert names.count("op_resolution") == 3 and "hist.drain" in names
    assert "flight_drain" in names and "trace_sidecar" in names
    assert log["summary"]["ticks_recorded"] == 11 and log["ticks"][-1]["tick"] == 10
    # a broken log fails both validators alike
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write('{"kind": "tick", "tick": 1, "metrics": {}}\nnot json\n')
    assert prec.validate_run_log(bad) == jrec.validate_run_log(bad) != []


def test_iter_tick_rows_equal_jax():
    m = {"a": np.arange(4), "b": np.ones((4, 2))}
    got, want = list(prec.iter_tick_rows(m)), list(jrec.iter_tick_rows(m))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in g)
    with pytest.raises(ValueError, match="ragged"):
        list(prec.iter_tick_rows({"a": np.arange(3), "b": np.arange(4)}))
