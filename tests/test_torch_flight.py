"""The port's flight recorder (and the full engine's histograms) against the
JAX package, tick by tick, bit for bit.

Both engines start from one state and run tests/test_torch_engine.py's
schedule (a bootstrap tick, then kills, a revive, a graceful leave and a
rejoin at n=32, ``suspicion_ticks=6``) with the obs planes on, in the fused
tick ("xla" in JAX, "plain" in the port) and the classic one ("off"), both
``gate_phases`` settings, fast and farmhash checksums.  Every SimState
field — ``ev_buf``, ``ev_head``, ``ev_drops``, ``first_heard`` and ``hist``
with the protocol's — and every TickMetrics field must be equal on every
tick.  Two cases use a buffer too small for the run, which must drop the
same events.  Then the cluster drains: ``drain_events`` equal to the JAX
cluster's, ``reconcile`` all-match, ``export_flight_trace`` valid and equal
to the JAX export, and turning the planes on leaves the trajectory
unchanged.  Tolerance: none (all integer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.models.sim import flight as jflight
from ringpop_tpu.models.sim.cluster import SimCluster as JaxSimCluster
from ringpop_tpu.models.sim.cluster import default_addresses
from ringpop_tpu.obs import chrome_trace as jct
from ringpop_tpu.ops import checksum_encode as jce
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import flight as pflight
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.obs import chrome_trace as pct
from ringpop_tpu_torch.obs import events as pev
from ringpop_tpu_torch.ops import checksum_encode as pce
from tests.models.test_fused_tick import _schedule
from tests.test_torch_engine import _events

N = 32
TICKS = 32


def _jax_params(ft, gate, mode, cap, recorder=True, hist=True, n=N):
    return je.SimParams(
        n=n, checksum_mode=mode, suspicion_ticks=6, gate_phases=gate, fused_tick=ft,
        fused_checksum="on" if mode == "farmhash" else "off", hash_impl="scan",
        parity_recompute="bounded" if mode == "farmhash" else "auto", dirty_batch=n,
        flight_recorder=recorder, histograms=hist, event_capacity=cap,
    )


def _state_fields(js) -> dict:
    return {f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
            for f in je.SimState._fields}


@pytest.fixture(scope="module")
def universes():
    addrs = default_addresses(N)
    return jce.Universe.from_addresses(addrs), pce.Universe.from_addresses(addrs)


@pytest.mark.parametrize(
    "ft,gate,mode,cap,recorder,hist",
    [
        ("xla", True, "fast", 65536, True, True),
        ("xla", False, "farmhash", 512, True, True),  # overflows: drops counted
        ("off", True, "farmhash", 65536, True, True),
        ("off", False, "fast", 300, True, True),  # overflows
        ("xla", False, "fast", 4096, True, False),  # the recorder alone
        ("off", True, "fast", 4096, False, True),  # the histograms alone
    ],
)
def test_planes_bitwise_equal_to_jax_every_tick(universes, ft, gate, mode, cap, recorder, hist):
    ju, pu = universes
    jp = _jax_params(ft, gate, mode, cap, recorder, hist)
    pp = convert.params_from_jax_fields(jp._asdict())
    assert (pp.flight_recorder, pp.histograms, pp.event_capacity) == (recorder, hist, cap)
    js = je.init_state(jp, seed=1, universe=ju)
    ps = pe.init_state(pp, seed=1, universe=pu)
    jtick = jax.jit(lambda s, i: je.tick(s, i, jp, ju))
    total_drops = 0
    for t, ev in enumerate(_events(N, TICKS)):
        js, jm = jtick(js, je.TickInputs(**{k: jnp.asarray(v) for k, v in ev.items()}))
        ps, pm = pe.tick(ps, pe.TickInputs(**{k: torch.as_tensor(v) for k, v in ev.items()}),
                         pp, pu)
        want, got = _state_fields(js), convert.state_to_numpy(ps)
        label = "%s gate=%s %s cap=%d tick %d" % (ft, gate, mode, cap, t)
        for f in pe.SimState._fields:
            assert (want[f] is None) == (got[f] is None), (label, f)
            if want[f] is not None:
                assert np.array_equal(got[f], want[f]), "%s: field %s differs" % (label, f)
        for f in pe.TickMetrics._fields:
            assert int(getattr(pm, f)) == int(np.asarray(getattr(jm, f))), (label, f)
        if recorder:
            assert ps.ev_head.shape == () and ps.ev_head.dtype == torch.int32
            total_drops = int(ps.ev_drops)
    if recorder and cap < 1000:
        assert total_drops > 0  # the small buffer really overflowed
    if hist:
        assert int(convert.state_to_numpy(ps)["hist"].astype(np.int64).sum()) > 0


@pytest.mark.parametrize("cap,head", [(64, 0), (64, 50), (16, 16), (1000, 3)])
def test_append_events_equal_jax(cap, head):
    rng = np.random.default_rng(cap + head)
    m = 40
    mask = rng.random(m) < 0.6
    cols = [rng.integers(-5, 100, m).astype(np.int32) for _ in range(4)]
    buf0 = rng.integers(-9, 9, (cap, pev.RECORD_WIDTH)).astype(np.int32)
    jb, jh, jd = jflight.append_events(
        jnp.asarray(buf0), jnp.int32(head), jnp.int32(2), jnp.asarray(mask), jnp.int32(7), 3,
        observer=jnp.asarray(cols[0]), subject=jnp.asarray(cols[1]), old_status=jnp.int32(-1),
        new_status=jnp.asarray(cols[2]), inc=jnp.int32(0), aux=jnp.asarray(cols[3]),
    )
    app = pflight._Appender(torch.as_tensor(buf0), torch.tensor(head, dtype=torch.int32),
                            torch.tensor(2, dtype=torch.int32))
    app.append(torch.as_tensor(mask), torch.tensor(7, dtype=torch.int32), 3,
               torch.as_tensor(cols[0]), torch.as_tensor(cols[1]), -1,
               torch.as_tensor(cols[2]), 0, torch.as_tensor(cols[3]))
    pb, ph, pd = app.result()
    assert np.array_equal(pb.numpy(), np.asarray(jb))
    assert (int(ph), int(pd)) == (int(jh), int(jd))


def test_layout_and_bounds_equal_jax():
    assert pflight.max_events_per_tick(1024, 3) == jflight.max_events_per_tick(1024, 3)
    for got, want in zip(pflight.init_recorder_fields(12, 77),
                         jflight.init_recorder_fields(12, 77)):
        assert np.array_equal(got.numpy(), np.asarray(want)) and got.dtype == torch.int32
    assert pflight.TickEventMasks._fields == jflight.TickEventMasks._fields
    assert pe.SimState._fields == je.SimState._fields
    assert pe.HIST_TRACKS == je.HIST_TRACKS


def _pair(flight=True, hist=True, n=16, cap=65536):
    kw = dict(n=n, checksum_mode="fast", suspicion_ticks=6, flight_recorder=flight,
              histograms=hist, event_capacity=cap)
    j = JaxSimCluster(n=n, params=je.SimParams(fused_tick="xla", **kw), seed=3)
    p = SimCluster(n=n, params=pe.SimParams(**kw), seed=3, device="cpu")
    return j, p


def _port_sched(n, ticks):
    s = _schedule(n, ticks)
    return EventSchedule(ticks=ticks, n=n, kill=s.kill, revive=s.revive, join=s.join,
                         partition=s.partition, leave=s.leave)


def test_cluster_drains_equal_jax():
    j, p = _pair()
    for c in (j, p):
        c.bootstrap()
    assert p.drain_events() == j.drain_events()
    jm = j.run(_schedule(16, 24))
    pm = p.run(_port_sched(16, 24))
    assert p.event_drops() == j.event_drops() == 0
    assert np.array_equal(p.first_heard(), j.first_heard())
    events = p.drain_events(reset=False)
    assert events == j.drain_events(reset=False) and events
    rec = pev.reconcile(events, pm)
    assert rec and all(v["match"] for v in rec.values()), rec
    assert rec == pev.reconcile(events, jm)
    trace = p.export_flight_trace()
    assert pct.validate_chrome_trace(trace) == [] and jct.validate_chrome_trace(trace) == []
    want = j.export_flight_trace()
    assert trace["otherData"].pop("generator") == "ringpop_tpu_torch.obs.chrome_trace"
    want["otherData"].pop("generator")
    assert trace == want
    # the export drained both buffers; the histograms drain equal too
    assert p.drain_events() == [] and p.event_drops() == 0
    assert p.drain_histograms() == j.drain_histograms()
    assert np.array_equal(convert.state_to_numpy(p.state)["hist"], np.asarray(j.state.hist))


def test_drains_need_their_plane():
    _, p = _pair(flight=False, hist=False, n=8)
    for call in (p.drain_events, p.first_heard, p.drain_histograms):
        with pytest.raises(ValueError, match="SimParams"):
            call()
    assert p.event_drops() == 0
    # the statsd sink: the port's bridge emits the JAX bridge's calls
    from ringpop_tpu.obs.statsd_bridge import StatsdBridge as JaxBridge
    from ringpop_tpu.utils.stats import CapturingStatsd
    from ringpop_tpu_torch.obs.statsd_bridge import StatsdBridge

    j, h = _pair(flight=False, hist=True, n=8)
    j.bootstrap()
    h.bootstrap()
    jcap, pcap = CapturingStatsd(), CapturingStatsd()
    j.drain_histograms(statsd=JaxBridge(statsd=jcap, host_port="127.0.0.1:3000"))
    h.drain_histograms(statsd=StatsdBridge(statsd=pcap, host_port="127.0.0.1:3000"))
    assert pcap.records == jcap.records


@pytest.mark.parametrize("gate", [True, False])
def test_planes_are_trajectory_neutral(gate):
    """Every protocol field and metric equal with the planes on and off,
    drains between windows included."""
    runs = []
    for on in (False, True):
        p = pe.SimParams(n=N, checksum_mode="fast", suspicion_ticks=6, gate_phases=gate,
                         flight_recorder=on, histograms=on, event_capacity=256)
        sim = SimCluster(n=N, params=p, seed=2, device="cpu")
        ms = [sim.bootstrap()]
        if on:
            sim.drain_events()
        ms.append(sim.run(_port_sched(N, 16)))
        if on:
            sim.drain_histograms()
            assert sim.event_drops() > 0  # a full buffer must not matter either
        ms.append(sim.run(_port_sched(N, 16)))
        runs.append((sim, ms))
    (off, m_off), (on, m_on) = runs
    for f in pe.SimState._fields:
        a = getattr(off.state, f)
        if a is not None:
            assert torch.equal(a, getattr(on.state, f)), f
    for a, b in zip(m_off, m_on):
        for f in pe.TickMetrics._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
