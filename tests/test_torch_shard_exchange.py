"""The port's exchange plane over the shard mesh (the counterpart of
tests/parallel/test_shard_exchange.py).

The plane ("kernel" on the CPU runs the kernel wrapper's plain version on
each shard) is held bitwise against the gate twin ("plain": the direct
round's partner rows by the uncapped all-gather), through the forced
``cap=1`` overflow (every route takes the all-gather fallback), and step
by step against a run; the cap and the traffic model, the resolution
table, the resolution note and the statsd gauges against JAX's.  The JAX
persistent compilation cache is off in this module (``no_jax_cache``,
tests/test_torch_mesh.py).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.ops import exchange as jexch
from ringpop_tpu.parallel import mesh as jmesh
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.obs.recorder import RunRecorder
from ringpop_tpu_torch.obs.statsd_bridge import StatsdBridge
from ringpop_tpu_torch.ops import exchange as pexch
from ringpop_tpu_torch.parallel import mesh as pmesh
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)
from tests.test_torch_mesh import no_jax_cache  # noqa: F401  (a fixture)


def _params(n, **kw):
    kw.setdefault("u", 192)
    kw.setdefault("suspicion_ticks", 5)
    return pes.ScalableParams(n=n, **kw)


def _sched(ticks, n, seed=4):
    sched = StormSchedule.churn_storm(ticks, n, fraction=0.1, fail_tick=2, seed=seed)
    part = np.full((ticks, n), -1, np.int32)
    part[ticks // 3] = (np.arange(n) < n // 4).astype(np.int32)
    part[2 * ticks // 3] = 0
    sched.partition = part
    return sched


def _assert_states_equal(a, b, ctx=""):
    a, b = convert.scalable_state_to_numpy(a), convert.scalable_state_to_numpy(b)
    for f in pes.ScalableState._fields:
        assert (a[f] is None and b[f] is None) or np.array_equal(a[f], b[f]), ctx + f


def _mesh(s):
    return pmesh.make_mesh(s, device="cpu")


@pytest.fixture(scope="module")
def single64():
    n, ticks = 64, 16
    single = ScalableCluster(n=n, params=_params(n), seed=4, device="cpu")
    single.run(_sched(ticks, n))
    return single


def test_kernel_plane_matches_the_gather_twin(single64):
    """The fallback gate: the plane with the "kernel" route (its plain
    version here) against fused_exchange="plain" on the same mesh — the
    per-shard tick with the all-gathered partner rows."""
    n, ticks = 64, 16
    plane = pmesh.ShardedStorm(n=n, mesh=_mesh(8), params=_params(n, fused_exchange="kernel"),
                               seed=4)
    twin = pmesh.ShardedStorm(n=n, mesh=_mesh(8), params=_params(n, fused_exchange="plain"), seed=4)
    assert (plane.exchange_mode, plane.exchange_impl) == ("shard_map", "kernel")
    assert (twin.exchange_mode, twin.exchange_impl) == ("gspmd", "plain")
    mp = plane.run(_sched(ticks, n))
    mt = twin.run(_sched(ticks, n))
    _assert_states_equal(plane.state, twin.state)
    for f in mp._fields:
        assert np.array_equal(getattr(mp, f), getattr(mt, f)), f
    _assert_states_equal(single64.state, plane.state)
    # the plane routed with all-to-alls, the twin gathered whole planes
    assert plane.comm.calls["all_to_all"] > 0 and twin.comm.calls["all_to_all"] > 0
    assert twin.comm.gather_bytes > plane.comm.gather_bytes


def test_classic_off_mode_on_the_mesh(single64):
    n, ticks = 64, 16
    off = pmesh.ShardedStorm(n=n, mesh=_mesh(4), params=_params(n, fused_exchange="off"), seed=4)
    assert (off.exchange_mode, off.exchange_impl) == ("gspmd", "off")
    off.run(_sched(ticks, n))
    _assert_states_equal(single64.state, off.state)


def test_overflow_fallback_bitwise_equal(single64):
    """cap=1 overflows every bucket: every route takes the all-gather
    fallback, agreed by one host read a route — the trajectory does not
    move."""
    n, ticks = 64, 16
    storm = pmesh.ShardedStorm(n=n, mesh=_mesh(8), params=_params(n), seed=4,
                               exchange_cap_override=1)
    assert storm.exchange_cap == 1
    before = pes.host_read.count
    storm.run(_sched(ticks, n))
    reads = pes.host_read.count - before
    _assert_states_equal(single64.state, storm.state)
    assert storm.comm.calls["all_to_all"] == 0 and storm.comm.gather_bytes > 0
    # the same run with the default cap: the same host reads (one a route
    # either way), the buckets sent by all-to-all
    again = pmesh.ShardedStorm(n=n, mesh=_mesh(8), params=_params(n), seed=4)
    before = pes.host_read.count
    again.run(_sched(ticks, n))
    assert pes.host_read.count - before == reads
    assert again.comm.calls["all_to_all"] > 0


def test_step_and_run_agree_under_the_plane():
    n, ticks = 32, 8
    params = _params(n, u=160)
    a = pmesh.ShardedStorm(n=n, mesh=_mesh(4), params=params, seed=7)
    b = pmesh.ShardedStorm(n=n, mesh=_mesh(4), params=params, seed=7)
    ma = a.run(_sched(ticks, n, seed=7))
    inputs = _sched(ticks, n, seed=7)
    mb = [b.step(pes.ChurnInputs(kill=inputs.kill[t], revive=inputs.revive[t],
                                 partition=inputs.partition[t])) for t in range(ticks)]
    _assert_states_equal(a.state, b.state)
    for f in ma._fields:
        assert np.array_equal(getattr(ma, f), np.stack([getattr(m, f) for m in mb])), f
    assert a.tick_count == b.tick_count == ticks


def test_exchange_cap_and_traffic_model_equal_jax():
    for n, shards in ((64, 8), (64, 1), (1024, 4), (1_000_000, 4), (1_000_000, 8)):
        local = n // shards
        assert pmesh.exchange_cap(local, shards) == jmesh.exchange_cap(local, shards)
        assert (pexch.cross_shard_traffic_bytes(n, 16, shards)
                == jexch.cross_shard_traffic_bytes(n, 16, shards))
        assert pexch.cross_shard_traffic_bytes(n, 16, shards)["cap"] == pmesh.exchange_cap(
            local, shards)
    assert pexch.cross_shard_traffic_bytes(64, 16, 1)["interconnect_total"] == 0
    # the plane's cap is the storm's
    storm = pmesh.ShardedStorm(n=64, mesh=_mesh(8), params=_params(64))
    assert storm.exchange_cap == pmesh.exchange_cap(8, 8)


def test_routed_bytes_match_the_traffic_model():
    """One direction's all-to-all payload and position planes between
    distinct shards are what the traffic model charges a tick."""
    n, shards, ticks = 64, 4, 6
    storm = pmesh.ShardedStorm(n=n, mesh=_mesh(shards), params=_params(n, packet_loss=0.0), seed=4)
    storm.run(StormSchedule(ticks=ticks, n=n))
    model = pexch.cross_shard_traffic_bytes(n, 192 // 32, shards)
    # quiet ticks: only the plane's two routes a tick (no indirect round)
    assert storm.comm.calls["all_to_all"] == 4 * ticks
    assert storm.comm.a2a_bytes == model["interconnect_total"] * ticks


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_resolution_table_pinned(backend):
    table = {
        "auto": ("shard_map", "kernel" if backend == "cuda" else "plain"),
        "kernel": ("shard_map", "kernel"),
        "plain": ("gspmd", "plain"),
        "off": ("gspmd", "off"),
    }
    for fe, want in table.items():
        for shards in (1, 8):
            got = pes.resolve_sharded_exchange(pes.ScalableParams(n=16, fused_exchange=fe),
                                               backend, shards)
            assert got == want, (fe, backend, shards)
    with pytest.raises(ValueError):
        pes.resolve_sharded_exchange(pes.ScalableParams(n=16, fused_exchange="xla"), backend, 8)
    with pytest.raises(ValueError):
        pes.resolve_sharded_exchange(pes.ScalableParams(n=16), backend, 0)


class _Capture:
    def __init__(self):
        self.calls = []

    def gauge(self, key, value):
        self.calls.append(("gauge", key, value))

    def increment(self, key, value=1):
        self.calls.append(("increment", key, value))

    def timing(self, key, value):
        self.calls.append(("timing", key, value))


def test_resolution_note_and_gauges_equal_jax(no_jax_cache, tmp_path):
    """For an explicit request the note and the gauges are JAX's, call for
    call (the impl names mapped: pallas -> kernel, xla -> plain); "auto"
    differs only where the single-device picks differ (JAX's CPU pick is
    "off", the port's "plain")."""
    from ringpop_tpu.obs.statsd_bridge import StatsdBridge as JaxBridge

    n = 16
    names = {"pallas": "kernel", "xla": "plain", "off": "off"}
    for jfe in ("pallas", "xla", "off"):
        js = jmesh.ShardedStorm(n=n, mesh=jmesh.make_mesh(8),
                                params=jes.ScalableParams(n=n, u=160, fused_exchange=jfe), seed=0)
        ps = pmesh.ShardedStorm(n=n, mesh=_mesh(8),
                                params=_params(n, u=160, fused_exchange=names[jfe]), seed=0)
        jnote, pnote = js.exchange_resolution(), ps.exchange_resolution()
        assert pnote.pop("devices") == ["cpu"] * 8
        for k in ("requested", "impl", "single_device_resolution"):
            jnote[k] = names.get(jnote[k], jnote[k])
        if jfe == "off":
            # single-device pick of an explicit request: the request itself
            assert pnote["single_device_resolution"] == "off"
        assert pnote == jnote, jfe
        jcap, pcap = _Capture(), _Capture()
        js.emit_resolution_stat(JaxBridge(statsd=jcap, host_port="127.0.0.1:3000"))
        ps.emit_resolution_stat(StatsdBridge(statsd=pcap, host_port="127.0.0.1:3000"))
        assert pcap.calls == jcap.calls and pcap.calls, jfe
    auto = pmesh.ShardedStorm(n=n, mesh=_mesh(8), params=_params(n, u=160), seed=0)
    note = auto.exchange_resolution()
    assert (note["mode"], note["impl"], note["cap"]) == ("shard_map", "plain", 2)
    assert note["differs_from_single_device"] is False
    # the run-log face: one mesh_exchange_resolution event row
    rec = RunRecorder(str(tmp_path) + "/", run_id="meshres")
    auto.attach_recorder(rec)
    auto.step()
    rec.finish()
    rows = [json.loads(line) for line in open(rec.path, encoding="utf-8") if line.strip()]
    events = [r for r in rows if r.get("kind") == "event"
              and r.get("name") == "mesh_exchange_resolution"]
    assert len(events) == 1
    for field in ("requested", "mode", "impl", "shards", "cap", "single_device_resolution",
                  "differs_from_single_device", "devices"):
        assert field in events[0], field
    assert events[0]["shards"] == 8 and events[0]["devices"] == ["cpu"] * 8


def test_plane_kernel_route_runs_one_exchange_a_shard(monkeypatch):
    """Each shard's body calls the exchange once a tick on its own tile:
    on the CPU the kernel wrapper takes the plain version, so count the
    wrapper's calls."""
    seen = []
    real = pexch.exchange

    def spy(heard, *a, **kw):
        seen.append(tuple(heard.shape))
        return real(heard, *a, **kw)

    monkeypatch.setattr(pexch, "exchange", spy)
    n, shards, ticks = 64, 4, 5
    storm = pmesh.ShardedStorm(n=n, mesh=_mesh(shards), params=_params(n, fused_exchange="kernel"),
                               seed=4)
    storm.run(StormSchedule.churn_storm(ticks, n, fraction=0.1, fail_tick=1, seed=4))
    assert seen == [(n // shards, 192 // 32)] * (shards * ticks)
    assert torch.is_tensor(storm.state.heard)
