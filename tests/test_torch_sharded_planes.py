"""The obs planes on both shard meshes, against the single-device twins
and against JAX's mesh drivers.

``ShardedSim`` with the flight recorder and the histograms on is held
every tick (every ``SimState`` field, ``ev_buf`` with its stale records
past the head, ``ev_head``, ``ev_drops``, ``first_heard`` and ``hist``
included) against the planes-on ``SimCluster`` at 1, 2, 4 and 8 shards in
fast mode and at 4 in farmhash mode (fused checksum on and off); with
buffers that overflow in the middle of a tick; across a mid-run reset of
the head and drop counter; read through ``obs.events.decode_events`` and
``obs.histograms.summarize`` against the twin's drains; with the host
reads of the planes-off mesh; and against JAX's ``ShardedSim`` at 4
shards, a 4-shard manifest finishing in either package.  ``ShardedStorm``
with the wavefront and the histograms on is held against
``ScalableCluster`` at 1, 2, 4 and 8 shards and against JAX's at 8, with
a checkpoint whose common file holds both planes resumed on 2 shards and
in JAX.  The state split and join round trip with every plane on, and
the two bumps every shard computes alike (the storm's retirement ages,
the full engine's dirty rows) are counted once.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine as jengine
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.cluster import EventSchedule as JaxSchedule
from ringpop_tpu.models.sim.storm import StormSchedule as JaxStorm
from ringpop_tpu.parallel import mesh as jmesh
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim import flight
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.obs import events as oe
from ringpop_tpu_torch.obs import histograms as oh
from ringpop_tpu_torch.parallel import ShardedSim, ShardedStorm, make_mesh
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)
from tests.test_torch_mesh import no_jax_cache  # noqa: F401  (a fixture)

CPU = "cpu"
N = 32
TICKS = 12
CAP = 4096
STORM_N, STORM_TICKS, STORM_CUT = 64, 20, 10


def _params(mode="fast", cap=CAP, **kw):
    return pe.SimParams(n=N, checksum_mode=mode, flight_recorder=True, histograms=True,
                        event_capacity=cap, **kw)


def _kill(ticks=TICKS):
    """Three nodes killed at tick 4, two revived at tick 7 (if it comes)."""
    kill = np.zeros((ticks, N), bool)
    kill[4, :3] = True
    revive = np.zeros((ticks, N), bool)
    revive[7:8, :2] = True
    return kill, revive


def _state_np(state) -> dict:
    return {f: None if x is None else x.to(CPU).numpy().copy()
            for f, x in zip(state._fields, state)}


def _trajectory(sim, ticks=TICKS, reset_at=None) -> list:
    """Bootstrap, then one step a tick of :func:`_kill`: each tick's
    metrics and whole state.  ``reset_at``: before that tick, the head and
    the drop counter go back to 0 (the twin drains its events)."""
    kill, revive = _kill(ticks)
    out = [(sim.bootstrap(), _state_np(sim.state))]
    for t in range(ticks):
        if t == reset_at:
            if isinstance(sim, SimCluster):
                sim.drain_events()
            else:
                zero = torch.zeros((), dtype=torch.int32)
                sim.state = sim.state._replace(ev_head=zero, ev_drops=zero)
        inp = pe.TickInputs.quiet(N)._replace(kill=torch.as_tensor(kill[t]),
                                              revive=torch.as_tensor(revive[t]))
        out.append((sim.step(inp), _state_np(sim.state)))
    return out


def _assert_state(want: dict, got: dict, ctx) -> None:
    for f in pe.SimState._fields:
        a, b = want[f], got[f]
        assert (a is None and b is None) or np.array_equal(a, b), (ctx, f)


def _assert_trajectory(want, got, ctx: str) -> None:
    assert len(want) == len(got)
    for t, ((mw, sw), (mg, sg)) in enumerate(zip(want, got)):
        for f in pe.TickMetrics._fields:
            assert np.array_equal(getattr(mw, f), getattr(mg, f)), (ctx, t, f)
        _assert_state(sw, sg, (ctx, t))


def _twin(params, **kw):
    return _trajectory(SimCluster(n=N, params=params, seed=3, device=CPU), **kw)


def _mesh(params, shards):
    return ShardedSim(N, make_mesh(shards, device=CPU), params=params, seed=3)


@pytest.fixture(scope="module")
def fast_twin():
    return _twin(_params())


# ---------------------------------------------------------------------------
# ShardedSim with the planes on == SimCluster with the planes on


@pytest.mark.parametrize("shards", (1, 2, 4, 8))
def test_planes_on_mesh_equals_sim_cluster_every_tick(fast_twin, shards):
    sim = _mesh(_params(), shards)
    tile = sim.shard_states[0]
    assert tile.first_heard.shape == (N // shards, N)
    assert tile.ev_buf.shape == (CAP // shards, 8) and tile.hist.shape == (4, 32)
    got = _trajectory(sim)
    _assert_trajectory(fast_twin, got, "S=%d" % shards)
    assert int(got[-1][1]["ev_drops"]) == 0 and int(got[-1][1]["ev_head"]) > 0


@pytest.mark.parametrize("fused_checksum", ("on", "off"))
def test_farmhash_planes_on_mesh_equals_sim_cluster(fused_checksum):
    p = _params("farmhash", fused_checksum=fused_checksum,
                **({} if fused_checksum == "on" else dict(dirty_batch=5)))
    _assert_trajectory(_twin(p, ticks=8), _trajectory(_mesh(p, 4), ticks=8),
                       "farmhash " + fused_checksum)


def _heads(traj) -> list:
    return [int(s["ev_head"]) for _, s in traj]


@pytest.mark.parametrize("shards", (2, 4))
@pytest.mark.parametrize("where", ("bootstrap", "kill tick"))
def test_overflowing_buffer_drops_as_the_twin(fast_twin, shards, where):
    """A capacity that fills in the middle of a tick (``np.array_split``
    blocks of unequal rows: the capacity is odd): the same records, head
    and drops on every tick, and the tick really wrote and dropped."""
    heads = _heads(fast_twin)
    t = 0 if where == "bootstrap" else 5  # the tick after the kills
    before = heads[t - 1] if t else 0
    cap = (before + (heads[t] - before) // 2) | 1
    p = _params(cap=cap)
    want = _twin(p)
    assert int(want[t - 1][1]["ev_drops"] if t else 0) == 0
    assert int(want[t][1]["ev_drops"]) > 0 and int(want[t][1]["ev_head"]) == cap
    sim = _mesh(p, shards)
    assert [st.ev_buf.shape[0] for st in sim.shard_states] == [
        len(b) for b in np.array_split(np.arange(cap), shards)]
    _assert_trajectory(want, _trajectory(sim), "cap=%d S=%d" % (cap, shards))


@pytest.mark.parametrize("shards", (2, 4))
def test_reset_of_head_and_drops_keeps_stale_records(shards):
    """The head and drop counter reset mid-run (the twin drains): later
    ticks overwrite the buffer from row 0 and leave the stale records past
    the new head as they were, on the mesh as on the twin."""
    p = _params(cap=1500)
    want = _twin(p, reset_at=6)
    got = _trajectory(_mesh(p, shards), reset_at=6)
    _assert_trajectory(want, got, "reset S=%d" % shards)
    last = got[-1][1]
    assert int(last["ev_head"]) < 1500 and last["ev_buf"][int(last["ev_head"]):].any()


def test_decoded_events_and_histograms_equal_the_twins_drains():
    p = _params()
    kill, _ = _kill()
    twin = SimCluster(n=N, params=p, seed=3, device=CPU)
    sim = _mesh(p, 4)
    for c in (twin, sim):
        c.bootstrap()
        c.run(EventSchedule(ticks=TICKS, n=N, kill=kill))
    st = sim.state
    head, drops = int(st.ev_head), int(st.ev_drops)
    events = oe.decode_events(st.ev_buf[:head].numpy(), head, drops)
    summary = oh.summarize(st.hist, pe.HIST_TRACKS)
    assert events and events == twin.drain_events()
    assert summary == twin.drain_histograms()
    assert all(summary[k]["count"] for k in ("rumor_age", "retired_age", "dirty_rows"))


def _host_reads(sim, sched) -> int:
    before = pes.host_read.count
    sim.run(sched)
    return pes.host_read.count - before


def test_planes_add_no_host_read_on_the_mesh():
    """Planes on and off, the same host reads a window; on ShardedSim the
    planes add two gathers (the emission counts, the candidate lanes) and
    one sum (the histogram bumps) a tick and nothing else, on ShardedStorm
    one sum a tick."""
    kill, _ = _kill()
    sched = EventSchedule(ticks=TICKS, n=N, kill=kill)
    on, off = _mesh(_params(), 4), _mesh(pe.SimParams(n=N, checksum_mode="fast"), 4)
    for sim in (on, off):
        sim.bootstrap()
    calls = [dict(sim.comm.calls) for sim in (on, off)]
    assert _host_reads(on, sched) == _host_reads(off, sched) > 0
    added = {op: (on.comm.calls[op] - calls[0].get(op, 0)) - (off.comm.calls[op] - calls[1].get(op, 0))
             for op in set(on.comm.calls) | set(off.comm.calls)}
    assert {op: k for op, k in added.items() if k} == {"gather": 2 * TICKS, "sum": TICKS}
    p = _storm_params(True, 4)  # the exchange telemetry on in both
    storm = [ShardedStorm(STORM_N, make_mesh(4, device=CPU), seed=4,
                          params=p._replace(wavefront=planes, histograms=planes))
             for planes in (True, False)]
    reads = [_host_reads(s, _storm_sched()) for s in storm]
    assert reads[0] == reads[1] > 0
    assert storm[0].comm.calls["sum"] - storm[1].comm.calls["sum"] == STORM_TICKS


# ---------------------------------------------------------------------------
# the state split and join, and the bumps counted once


@pytest.mark.parametrize("shards", (1, 2, 4, 8))
def test_split_and_join_round_trip_with_every_plane(shards):
    cap = 4099  # np.array_split's blocks differ in length
    sim = SimCluster(n=N, params=_params("farmhash", cap=cap), seed=3, device=CPU)
    sim.bootstrap()
    sim.run(EventSchedule(ticks=5, n=N, kill=_kill(5)[0]))
    parts = convert.split_sim_state(sim.state, [CPU] * shards)
    blocks = [flight.capacity_block(cap, shards, s) for s in range(shards)]
    assert [hi - lo for lo, hi in blocks] == [len(b) for b in np.array_split(np.arange(cap),
                                                                               shards)]
    for st, (lo, hi) in zip(parts, blocks):
        assert torch.equal(st.ev_buf, sim.state.ev_buf[lo:hi])
        assert torch.equal(st.hist, sim.state.hist) and st.ev_head.dim() == 0
        assert st.first_heard.shape == (N // shards, N)
    _assert_state(_state_np(sim.state), _state_np(convert.join_sim_state(parts, CPU)), "join")
    storm = ScalableCluster(n=STORM_N, params=_storm_params(True, shards), seed=4, device=CPU)
    storm.run(_storm_sched())
    sparts = convert.split_scalable_state(storm.state, [CPU] * shards, shards > 1)
    assert sparts[0].first_heard.shape == (STORM_N // shards, 128)
    assert all(torch.equal(st.hist, storm.state.hist) for st in sparts)
    back = convert.scalable_state_to_numpy(convert.gather_scalable_state(sparts, CPU, shards > 1))
    for f, a in convert.scalable_state_to_numpy(storm.state).items():
        assert (a is None and back[f] is None) or np.array_equal(a, back[f]), f


@pytest.mark.parametrize("engine", ("sim", "storm"))
def test_bumps_every_shard_computes_alike_are_counted_once(engine):
    """The full engine's ``dirty_rows`` (one whole-cluster observation a
    tick) and the storm's ``retired_age`` (read off the replicated rumor
    table) on 4 shards: each track the twin's, and non-empty."""
    if engine == "sim":
        p = _params()
        kill, _ = _kill()
        sched = EventSchedule(ticks=TICKS, n=N, kill=kill)
        twin, sim = SimCluster(n=N, params=p, seed=3, device=CPU), _mesh(p, 4)
        for c in (twin, sim):
            c.bootstrap()
            c.run(sched)
        tracks = pe.HIST_TRACKS
    else:
        # a short rumor life: retirements inside the window
        p = _storm_params(True, 4, u=32, piggyback_factor=2, age_slack=2)
        twin = ScalableCluster(n=STORM_N, params=p, seed=4, device=CPU)
        sim = ShardedStorm(STORM_N, make_mesh(4, device=CPU), params=p, seed=4)
        for c in (twin, sim):
            m = c.run(_storm_sched())
        assert int(m.rumors_retired.sum()) > 0
        tracks = pes.SCALABLE_HIST_TRACKS
    want, got = oh.host_counts(twin.state.hist), oh.host_counts(sim.state.hist)
    for track in ("dirty_rows",) if engine == "sim" else ("retired_age",):
        row = tracks.index(track)
        assert want[row].sum() > 0 and np.array_equal(want[row], got[row]), track
    assert np.array_equal(want, got)


# ---------------------------------------------------------------------------
# ShardedStorm with the planes on == ScalableCluster


def _storm_params(planes=True, shards=1, **kw):
    kw = dict(dict(u=128, suspicion_ticks=5), **kw)
    return pes.ScalableParams(n=STORM_N, wavefront=planes, histograms=planes,
                              exchange_metrics=shards if planes else 0, **kw)


def _storm_planes():
    base = StormSchedule.churn_storm(STORM_TICKS, STORM_N, fraction=0.1, fail_tick=2, seed=4)
    part = np.full((STORM_TICKS, STORM_N), -1, np.int32)
    part[6] = (np.arange(STORM_N) < STORM_N // 4).astype(np.int32)
    part[13] = 0
    return dict(kill=base.kill, revive=base.revive, partition=part)


def _storm_sched():
    return StormSchedule(ticks=STORM_TICKS, n=STORM_N, **_storm_planes())


def _assert_scalable(want: dict, got: dict, ctx: str) -> None:
    for f in pes.ScalableState._fields:
        a, b = want[f], got[f]
        assert (a is None and b is None) or np.array_equal(a, b), (ctx, f)


@pytest.mark.parametrize("shards", (1, 2, 4, 8))
def test_planes_on_storm_mesh_equals_scalable_cluster(shards):
    p = _storm_params(True, shards)
    twin = ScalableCluster(n=STORM_N, params=p, seed=4, device=CPU)
    sim = ShardedStorm(STORM_N, make_mesh(shards, device=CPU), params=p, seed=4)
    assert sim.shard_states[0].first_heard.shape == (STORM_N // shards, 128)
    assert sim.shard_states[-1].hist.shape == (3, 32)
    mw, mg = twin.run(_storm_sched()), sim.run(_storm_sched())
    for f in pes.ScalableMetrics._fields:
        if f != "mean_heard_frac" or shards == 1:
            assert np.array_equal(getattr(mw, f), getattr(mg, f)), f
    want = convert.scalable_state_to_numpy(twin.state)
    _assert_scalable(want, convert.scalable_state_to_numpy(sim.state), "S=%d" % shards)
    st = sim.state
    assert oe.scalable_wavefront_summary(st.first_heard.numpy(), st.r_birth.numpy(),
                                         st.r_active.numpy()) == twin.wavefront_summary()
    assert oh.summarize(st.hist, pes.SCALABLE_HIST_TRACKS) == twin.drain_histograms()


# ---------------------------------------------------------------------------
# against JAX's mesh drivers, checkpoints both ways


def _jax_fields(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if getattr(state, f) is not None}


def _assert_jax(jax_state: dict, port: dict, ctx: str) -> None:
    assert set(jax_state) == {f for f, a in port.items() if a is not None}, ctx
    for f, a in jax_state.items():
        assert np.array_equal(a, port[f]), (ctx, f)


def test_jax_sharded_sim_with_planes_both_ways(no_jax_cache, tmp_path):  # noqa: F811
    """JAX's ShardedSim and the port's, both planes on, 4 shards: equal
    metrics and state; each one's 4-shard manifest at tick 6 finishes
    bitwise in the other package."""
    kill, _ = _kill()
    first, second = kill[:6], kill[6:]
    jp = jengine.SimParams(n=N, checksum_mode="fast", flight_recorder=True, histograms=True,
                           event_capacity=CAP)
    jsim = jmesh.ShardedSim(n=N, mesh=jmesh.make_mesh(4), params=jp, seed=3)
    psim = _mesh(_params(), 4)
    jm = [jsim.bootstrap(), jsim.run(JaxSchedule(ticks=6, n=N, kill=first.copy()))]
    pm = [psim.bootstrap(), psim.run(EventSchedule(ticks=6, n=N, kill=first))]
    jsim.save(str(tmp_path / "jax"))
    psim.save(str(tmp_path / "port"))
    assert ckpt.read_manifest(str(tmp_path / "port"))["shards"] == 4
    jm.append(jsim.run(JaxSchedule(ticks=6, n=N, kill=second.copy())))
    pm.append(psim.run(EventSchedule(ticks=6, n=N, kill=second)))
    for a, b in zip(jm, pm):
        for f in pe.TickMetrics._fields:
            assert np.array_equal(np.asarray(getattr(a, f)), getattr(b, f)), f
    want = convert.state_to_numpy(psim.state)
    _assert_jax(_jax_fields(jsim.state), want, "jax vs port")
    jsim.load(str(tmp_path / "port"))
    jsim.run(JaxSchedule(ticks=6, n=N, kill=second.copy()))
    _assert_jax(_jax_fields(jsim.state), want, "port manifest in jax")
    back = _mesh(_params(), 4)
    back.load(str(tmp_path / "jax"))
    back.run(EventSchedule(ticks=6, n=N, kill=second))
    _assert_jax(_jax_fields(jsim.state), convert.state_to_numpy(back.state),
                "jax manifest in the port")


def test_jax_sharded_storm_with_planes_and_a_resumed_checkpoint(no_jax_cache,  # noqa: F811
                                                                tmp_path):
    """JAX's ShardedStorm and the port's at 8 shards (u=128, the least
    multiple of 32 the recycle guard allows at n=64), wavefront, histograms and exchange
    telemetry on: equal state.  The port's 8-shard save at tick 10 keeps
    ``first_heard`` and ``hist`` in its common file, and finishes bitwise
    on 2 port shards and in JAX."""
    jp = jes.ScalableParams(n=STORM_N, u=128, suspicion_ticks=5, wavefront=True,
                            histograms=True, exchange_metrics=8)
    jsched = JaxStorm(ticks=STORM_TICKS, n=STORM_N, **_storm_planes())
    jstorm = jmesh.ShardedStorm(n=STORM_N, mesh=jmesh.make_mesh(8), params=jp, seed=4)
    jstorm.run(jsched)
    want = _jax_fields(jstorm.state)
    port = ShardedStorm(STORM_N, make_mesh(8, device=CPU), params=_storm_params(True, 8), seed=4)
    port.run(_storm_sched().window(0, STORM_CUT))
    path = str(tmp_path / "mid")
    port.save(path)
    with np.load(str(tmp_path / "mid" / "common.npz")) as common:
        assert {"state.first_heard", "state.hist"} <= set(common.files)
        assert common["state.first_heard"].shape == (STORM_N, 128)
    port.run(_storm_sched().window(STORM_CUT, STORM_TICKS))
    _assert_jax(want, convert.scalable_state_to_numpy(port.state), "8 shards")
    two = ShardedStorm(STORM_N, make_mesh(2, device=CPU), params=_storm_params(True, 2), seed=0)
    two.load(path)
    two.run(_storm_sched().window(STORM_CUT, STORM_TICKS))
    got = convert.scalable_state_to_numpy(two.state)
    # the exchange counters restart on another shard count (a row a shard)
    for f in set(want) - {"exch", "exch_hist"}:
        assert np.array_equal(want[f], got[f]), f
    jstorm2 = jmesh.ShardedStorm(n=STORM_N, mesh=jmesh.make_mesh(8), params=jp, seed=0)
    jstorm2.load(path)
    jstorm2.run(jsched.window(STORM_CUT, STORM_TICKS))
    _assert_jax(want, _jax_fields(jstorm2.state), "port manifest in jax")
