"""The scalable engine's and the routing plane's obs planes against the JAX
package, bit for bit.

- The scalable tick with ``wavefront``, ``histograms`` and
  ``exchange_metrics=4`` on: tests/test_torch_scalable.py's storm (5% loss,
  a healed partition) and leave schedules, every ScalableState field —
  ``first_heard``, ``hist``, ``exch``, ``exch_hist`` with the protocol's —
  and every ScalableMetrics field equal on every tick.
- The exchange telemetry's analytic twin on its own, including a tick
  whose bucket occupancy overflows the cap (the fallback counters).
- ``ScalableCluster``'s drains (``drain_histograms``,
  ``drain_exchange_metrics``, ``wavefront_summary``) equal to the JAX
  cluster's after the same storm, and planes on vs off equal trajectories.
- ``RouteState.hist`` per tick in both ring implementations, and
  ``RoutedStorm.drain_histograms`` equal to the JAX drain.
- Each new ``convert`` field, both directions.

Tolerance: none (integer counters; ``mean_heard_frac`` bitwise as in the
other port tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.route import plane as jplane
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import ScalableCluster as JaxCluster
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu.ops import exchange as jex
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.route import plane as pplane
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.ops import exchange as pex
from ringpop_tpu_torch.ops import u32
from tests.test_torch_route_plane import _pair as _route_pair
from tests.test_torch_route_plane import _storm_kw, run_lockstep
from tests.test_torch_scalable import _assert_metrics, _assert_state, _events, _state_np
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

PLANES = dict(wavefront=True, histograms=True, exchange_metrics=4)


def _jax_params(kind, n, gate, **planes):
    kw = dict(n=n, u=192, suspicion_ticks=4, gate_phases=gate, perm_impl="sortless",
              fused_exchange="xla", **planes)
    if kind == "storm":
        kw["packet_loss"] = 0.05
    else:
        kw.update(enable_leave=True, u=256)
    return jes.ScalableParams(**kw)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(kind, n, gate):
    params = _jax_params(kind, n, gate, **PLANES)
    st = jes.init_state(params, seed=n + 1)
    step = jax.jit(functools.partial(jes.tick, params=params))
    init, out = _state_np(st), []
    for ev in _events(kind, n):
        st, m = step(st, jes.ChurnInputs(**{k: jnp.asarray(v) for k, v in ev.items()}))
        out.append((_state_np(st), {f: np.asarray(getattr(m, f)) for f in m._fields}))
    return init, out


@pytest.mark.parametrize("kind,n,gate,fused", [
    ("storm", 64, True, "plain"),
    ("storm", 100, False, "off"),
    ("leave", 64, False, "plain"),
])
def test_scalable_planes_bitwise_equal_to_jax_every_tick(kind, n, gate, fused):
    init, traj = _jax_trajectory(kind, n, gate)
    pp = convert.scalable_params_from_jax_fields(
        _jax_params(kind, n, gate, **PLANES)._asdict())._replace(fused_exchange=fused)
    assert (pp.wavefront, pp.histograms, pp.exchange_metrics) == (True, True, 4)
    ps = convert.scalable_state_from_numpy(init)
    for t, (ev, (want_s, want_m)) in enumerate(zip(_events(kind, n), traj)):
        ps, pm = pes.tick(ps, pes.ChurnInputs(**{k: torch.as_tensor(v) for k, v in ev.items()}),
                          pp)
        label = "%s n=%d gate=%s %s tick %d" % (kind, n, gate, fused, t)
        _assert_state(want_s, ps, label)
        _assert_metrics(want_m, pm, label)
    final = convert.scalable_state_to_numpy(ps)
    assert final["hist"].astype(np.int64).sum() > 0
    assert (final["first_heard"] >= 0).any()
    assert final["exch"][:, 0].tolist() == [len(traj)] * 4  # one round a tick


def test_wavefront_update_chunks_agree(monkeypatch):
    """The row-chunked wavefront stamp equals one pass."""
    rng = np.random.default_rng(6)
    n, u = 50, 64
    fh = torch.as_tensor(rng.integers(-1, 9, (n, u)).astype(np.int32))
    diff = torch.as_tensor(rng.integers(-(2**31), 2**31, (n, u // 32)).astype(np.int32))
    rows, cols = torch.as_tensor(rng.random(n) < 0.2), torch.as_tensor(rng.random(u) < 0.2)
    t = torch.tensor(11, dtype=torch.int32)
    whole = pes._wavefront_update(fh, diff, rows, cols, t)
    monkeypatch.setattr(pes, "_WAVE_CHUNK", 3 * u)
    assert torch.equal(pes._wavefront_update(fh, diff, rows, cols, t), whole)
    bits = np.unpackbits(diff.numpy().view(np.uint8), axis=1, bitorder="little").astype(bool)
    want = np.where(bits, 11, np.where(rows.numpy()[:, None] | cols.numpy()[None, :], -1,
                                       fh.numpy()))
    assert np.array_equal(whole.numpy(), want)
    assert np.array_equal(pes._column_bit_counts(diff).numpy(), bits.sum(axis=0))


@pytest.mark.parametrize("skew", [False, True])
def test_exchange_obs_update_equal_jax(skew):
    n, s = 2000, 2
    rng = np.random.default_rng(int(skew))
    partner0 = rng.permutation(n).astype(np.int32)
    inv = np.argsort(partner0).astype(np.int32)
    if skew:  # every pull addressed to shard 0: over the cap, the fallback
        inv = rng.integers(0, n // s, n).astype(np.int32)
    ok = rng.random(n) < 0.8
    je0 = jnp.asarray(np.full((s, len(jex.EXCH_COUNTERS)), 2**32 - 2, np.uint32))
    jh0 = jex.init_exchange_hist(s)
    jexch, jhist = jes._exchange_obs_update(je0, jh0, jnp.asarray(ok), jnp.asarray(partner0),
                                            jnp.asarray(inv), n)
    pexch, phist = pes._exchange_obs_update(
        u32.from_numpy(np.asarray(je0)), pex.init_exchange_hist(s), torch.as_tensor(ok),
        torch.as_tensor(partner0), torch.as_tensor(inv), n)
    assert np.array_equal(u32.to_numpy(pexch), np.asarray(jexch))
    assert np.array_equal(u32.to_numpy(phist), np.asarray(jhist))
    fallback = u32.to_numpy(pexch)[:, pex.EXCH_COUNTERS.index("fallback_pull")]
    assert (fallback == (2**32 - 1 if skew else 2**32 - 2)).all()


def test_exchange_layout_and_pricing_equal_jax():
    assert pex.EXCH_COUNTERS == jex.EXCH_COUNTERS
    assert pex.EXCH_HIST_TRACKS == jex.EXCH_HIST_TRACKS
    assert pex.ExchangeMetrics._fields == jex.ExchangeMetrics._fields
    assert pes.SCALABLE_HIST_TRACKS == jes.SCALABLE_HIST_TRACKS
    assert pes.ScalableState._fields == jes.ScalableState._fields
    for n, w, s, cap in ((1_000_000, 16, 4, None), (64, 6, 4, 9), (1000, 1, 1, None)):
        assert pex.cross_shard_traffic_bytes(n, w, s, cap) == jex.cross_shard_traffic_bytes(
            n, w, s, cap)
        assert pex.a2a_trip_bytes(w, s, 7) == jex.a2a_trip_bytes(w, s, 7)
        assert pex.fallback_trip_bytes(n // s, w, s) == jex.fallback_trip_bytes(n // s, w, s)
    counters = np.random.default_rng(2).integers(0, 2**32, (4, 9), dtype=np.uint64)
    counters = counters.astype(np.uint32)
    for cap in (None, 77):
        assert (pex.drain_exchange_counters(counters, w=16, cap=cap, local_rows=250)
                == jex.drain_exchange_counters(counters, w=16, cap=cap, local_rows=250))
    assert np.array_equal(pex.init_exchange_counters(3).numpy(),
                          np.asarray(jex.init_exchange_counters(3)).view(np.int32))
    with pytest.raises(ValueError):
        pex.drain_exchange_counters(counters[:, :5], w=16, cap=None, local_rows=250)


def _storm_pair(n=64, **planes):
    kw = dict(n=n, u=192, suspicion_ticks=4, packet_loss=0.05, **planes)
    j = JaxCluster(n=n, params=jes.ScalableParams(**kw), seed=5)
    p = ScalableCluster(n=n, params=pes.ScalableParams(**kw), seed=5, device="cpu")
    return j, p


def test_scalable_cluster_drains_equal_jax():
    j, p = _storm_pair(**PLANES)
    kw = dict(ticks=24, n=64, fraction=0.1, fail_tick=2, rejoin_tick=12, seed=4)
    jm, pm = j.run(JaxSchedule.churn_storm(**kw)), p.run(StormSchedule.churn_storm(**kw))
    for f in pes.ScalableMetrics._fields:
        assert np.array_equal(np.asarray(getattr(jm, f)), getattr(pm, f)), f
    snap = p.wavefront_snapshot()
    want = j.wavefront_snapshot()
    assert snap.keys() == want.keys()
    assert all(np.array_equal(snap[k], want[k]) for k in snap)
    summary = p.wavefront_summary()
    assert summary == j.wavefront_summary() and summary["rumors"]
    hs = p.drain_histograms()
    assert hs == j.drain_histograms() and hs["rumor_age"]["count"] > 0
    ex = p.drain_exchange_metrics()
    assert ex == j.drain_exchange_metrics()
    assert [r["ticks"] for r in ex["shards"]] == [24] * 4
    # the drains reset the counters
    assert int(p.state.hist.abs().sum()) == 0 and int(p.state.exch.abs().sum()) == 0
    assert p.drain_exchange_metrics()["totals"]["ticks"] == 0


def test_scalable_drains_need_their_plane():
    _, p = _storm_pair()
    for call in (p.drain_histograms, p.drain_exchange_metrics, p.wavefront_snapshot):
        with pytest.raises(ValueError, match="ScalableParams"):
            call()


@pytest.mark.parametrize("gate", [True, False])
def test_scalable_planes_are_trajectory_neutral(gate):
    sched = StormSchedule.churn_storm(ticks=20, n=100, fraction=0.1, fail_tick=2, rejoin_tick=10,
                                      seed=1)
    out = []
    for planes in ({}, PLANES):
        c = ScalableCluster(n=100, params=pes.ScalableParams(
            n=100, u=192, suspicion_ticks=4, packet_loss=0.05, gate_phases=gate, **planes),
            seed=2, device="cpu")
        out.append((c.run(sched), c.state))
    (m0, s0), (m1, s1) = out
    for f in pes.ScalableMetrics._fields:
        assert np.array_equal(getattr(m0, f), getattr(m1, f)), f
    for f in pes.ScalableState._fields:
        if getattr(s0, f) is not None:
            assert torch.equal(getattr(s0, f), getattr(s1, f)), f


@pytest.mark.parametrize("impl", ["incremental", "full"])
def test_route_hist_bitwise_equal_to_jax_every_tick(impl):
    j, p = _route_pair(ring_impl=impl, histograms=True)
    assert p.rstate.hist is not None and p.route_params.histograms
    sched = JaxSchedule.churn_storm(**_storm_kw())
    run_lockstep(j, p, sched, sched.ticks)  # compares RouteState.hist too
    out = p.drain_histograms()
    assert out == j.drain_histograms() and set(out) == {"route"}
    assert out["route"]["retry_depth"]["count"] > 0
    assert int(p.rstate.hist.abs().sum()) == 0


def test_route_drains_both_planes_equal_jax():
    """RouteParams(histograms=True) with the engine's histograms on too."""
    n = 64
    kw = dict(n=n, u=192, suspicion_ticks=4, histograms=True)
    rkw = dict(queries_per_tick=256, key_space=1024, histograms=True)
    j = jplane.RoutedStorm(n, params=jes.ScalableParams(**kw),
                           route=jplane.RouteParams(n=n, **rkw), seed=1)
    p = pplane.RoutedStorm(n, params=pes.ScalableParams(**kw),
                           route=pplane.RouteParams(n=n, **rkw), seed=1, device="cpu")
    j.run(JaxSchedule.churn_storm(**_storm_kw(ticks=16)))
    p.run(StormSchedule.churn_storm(**_storm_kw(ticks=16)))
    out = p.drain_histograms()
    assert out == j.drain_histograms() and set(out) == {"route", "sim"}


def test_route_hist_is_trajectory_neutral():
    sched = StormSchedule.churn_storm(**_storm_kw(ticks=16))
    res = []
    for on in (False, True):
        _, p = _route_pair(histograms=on)
        em, rm = p.run(sched)
        res.append((em, rm, p.truth_ring()))
    for a, b in zip(res[0][:2], res[1][:2]):
        for f in a._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(res[0][2], res[1][2])


def test_convert_roundtrips_the_obs_fields():
    """Each new field crosses both ways: uint32 planes as int32 bits."""
    rng = np.random.default_rng(7)
    # SimState: ev_* and first_heard plain int32, hist uint32
    from ringpop_tpu_torch.models.sim import engine as pe
    from ringpop_tpu_torch.models.sim.cluster import SimCluster

    sim = SimCluster(n=8, params=pe.SimParams(n=8, checksum_mode="fast", flight_recorder=True,
                                              histograms=True, event_capacity=32), device="cpu")
    sim.bootstrap()
    arrays = convert.state_to_numpy(sim.state)
    arrays["hist"] = rng.integers(0, 2**32, arrays["hist"].shape, dtype=np.uint64).astype(
        np.uint32)
    assert arrays["ev_buf"].dtype == np.int32 and arrays["ev_head"].shape == ()
    back = convert.state_from_numpy(arrays, sim.params)
    again = convert.state_to_numpy(back)
    for f in ("ev_buf", "ev_head", "ev_drops", "first_heard", "hist"):
        assert again[f].dtype == arrays[f].dtype and np.array_equal(again[f], arrays[f]), f
        assert getattr(back, f).dtype == torch.int32, f
    fields = dict(n=8, flight_recorder=True, event_capacity=32, histograms=True)
    pp = convert.params_from_jax_fields(fields)
    assert (pp.flight_recorder, pp.event_capacity, pp.histograms) == (True, 32, True)
    # ScalableState: first_heard plain, hist / exch / exch_hist uint32
    st = pes.init_state(pes.ScalableParams(n=64, u=160, **PLANES), device="cpu")
    arrays = convert.scalable_state_to_numpy(st)
    for f in ("hist", "exch", "exch_hist"):
        assert arrays[f].dtype == np.uint32, f
        arrays[f] = rng.integers(0, 2**32, arrays[f].shape, dtype=np.uint64).astype(np.uint32)
    back = convert.scalable_state_to_numpy(convert.scalable_state_from_numpy(arrays))
    for f in ("first_heard", "hist", "exch", "exch_hist"):
        assert back[f].shape == arrays[f].shape and np.array_equal(back[f], arrays[f]), f
    sp = convert.scalable_params_from_jax_fields(dict(n=64, u=160, **PLANES))
    assert (sp.wavefront, sp.histograms, sp.exchange_metrics) == (True, True, 4)
    # RouteState.hist uint32
    _, p = _route_pair(n=16, histograms=True)
    arrays = convert.route_state_to_numpy(p.rstate)
    arrays["hist"] = np.full(arrays["hist"].shape, 2**32 - 5, np.uint32)
    back = convert.route_state_from_numpy(arrays)
    assert back.hist.dtype == torch.int32
    assert np.array_equal(convert.route_state_to_numpy(back)["hist"], arrays["hist"])
