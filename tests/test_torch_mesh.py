"""The port's ShardedStorm against JAX's, and against its own single-device
ScalableCluster (the counterpart of tests/parallel/test_mesh.py's scalable
half and of test_shard_exchange.py's shard-count gate).

The port's mesh is in-process: S shards on ``cpu``, one controller; JAX's
runs on the 8 forced XLA CPU devices.  Every ``ScalableState`` field and
every metric is held bitwise at 1, 2, 4 and 8 shards through a storm with
kills, revives, a partition split and heal and a graceful leave —
``mean_heard_frac`` too: it follows JAX's node-sharded mean, which rounds
differently from the single-device one.  The JAX persistent compilation
cache is off in this module, as tests/parallel/conftest.py turns it off
for JAX's own mesh tests (multi-device executables loaded back from it
can deadlock).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache as cc

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu.parallel import mesh as jmesh
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.parallel import mesh as pmesh
from tests._xla_mappings import bounded_mappings, drop_executables  # noqa: F401

SHARDS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def no_jax_cache():
    """JAX's persistent compilation cache off for the module (as
    tests/parallel/conftest.py turns it off: multi-device executables
    loaded back from it can deadlock), and the module's 8-device
    executables, several hundred memory mappings each, dropped after it
    (tests/_xla_mappings.py)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    cc.reset_cache()
    drop_executables()


def _kw(**extra):
    return dict(dict(u=192, suspicion_ticks=5), **extra)


def _planes(ticks, n, seed=4):
    """kill + rejoin + a partition split/heal: every phase next to the
    exchange (indirect rounds, publishes, refutes) runs in the window."""
    base = StormSchedule.churn_storm(ticks, n, fraction=0.1, fail_tick=2, seed=seed)
    part = np.full((ticks, n), -1, np.int32)
    part[ticks // 3] = (np.arange(n) < n // 4).astype(np.int32)
    part[2 * ticks // 3] = 0
    return dict(kill=base.kill, revive=base.revive, partition=part)


def _assert_state(want: dict, got, ctx=""):
    got = convert.scalable_state_to_numpy(got)
    for f in pes.ScalableState._fields:
        a, b = want[f], got[f]
        assert (a is None and b is None) or np.array_equal(np.asarray(a), b), ctx + f


def _assert_metrics(want, got, ctx="", skip=()):
    for f in pes.ScalableMetrics._fields:
        if f not in skip:
            assert np.array_equal(np.asarray(getattr(want, f)), np.asarray(getattr(got, f))), ctx + f


def _jax_state(storm) -> dict:
    return {f: None if getattr(storm.state, f) is None else np.asarray(getattr(storm.state, f))
            for f in pes.ScalableState._fields}


@pytest.fixture(scope="module")
def storm64(no_jax_cache):
    """The n=64 storm: the port's single-device run and JAX's ShardedStorm
    at every shard count, run once."""
    n, ticks = 64, 24
    kw = _kw(packet_loss=0.02)
    single = ScalableCluster(n=n, params=pes.ScalableParams(n=n, **kw), seed=4, device="cpu")
    m_single = single.run(StormSchedule(ticks=ticks, n=n, **_planes(ticks, n)))
    jax_runs = {}
    for s in SHARDS:
        js = jmesh.ShardedStorm(n=n, mesh=jmesh.make_mesh(s), params=jes.ScalableParams(n=n, **kw),
                                seed=4)
        jm = js.run(JaxSchedule(ticks=ticks, n=n, **_planes(ticks, n)))
        jax_runs[s] = (jax.tree.map(np.asarray, jm), _jax_state(js), np.asarray(js.checksums()))
    return dict(n=n, ticks=ticks, kw=kw, single=single, m_single=m_single, jax=jax_runs)


@pytest.mark.parametrize("shards", SHARDS)
def test_storm_bitwise_against_jax_and_single_device(storm64, shards):
    n, ticks, kw = storm64["n"], storm64["ticks"], storm64["kw"]
    storm = pmesh.ShardedStorm(n=n, mesh=pmesh.make_mesh(shards, device="cpu"),
                               params=pes.ScalableParams(n=n, **kw), seed=4)
    assert storm.exchange_mode == "shard_map" and storm.exchange_impl == "plain"
    m = storm.run(StormSchedule(ticks=ticks, n=n, **_planes(ticks, n)))
    jm, jstate, jcs = storm64["jax"][shards]
    ctx = "shards=%d: " % shards
    _assert_metrics(jm, m, ctx)
    _assert_state(jstate, storm.state, ctx)
    assert np.array_equal(storm.checksums(), jcs)
    single = storm64["single"]
    # the single-device twin: every state field and every integer metric;
    # the float mean rounds as the single-device one only at one shard
    _assert_state(convert.scalable_state_to_numpy(single.state), storm.state, ctx)
    _assert_metrics(storm64["m_single"], m, ctx, skip=() if shards == 1 else ("mean_heard_frac",))
    assert storm.ring_checksum() == single.ring_checksum()
    # the storm really moved: a suspect, a faulty and a refute, all live at the end
    assert m.suspects_published.sum() and m.faulties_published.sum() and m.refutes_published.sum()
    assert int(m.live_nodes[-1]) == n


def test_mean_heard_frac_follows_the_sharded_order(storm64):
    """The sharded mean rounds differently from the single-device one on
    some ticks (the reason it has its own order), and the port's follows
    JAX's at local lengths 32, 16 and 8 (n=64 above) and 2048, 1024 and
    512 (n=4096 here)."""
    single = np.asarray(storm64["m_single"].mean_heard_frac)
    assert any(not np.array_equal(storm64["jax"][s][0].mean_heard_frac, single) for s in (2, 4, 8))
    n, ticks = 4096, 10
    kw = dict(u=512, suspicion_ticks=5, packet_loss=0.3)
    for s in (2, 4, 8):
        js = jmesh.ShardedStorm(n=n, mesh=jmesh.make_mesh(s), params=jes.ScalableParams(n=n, **kw),
                                seed=1)
        jm = js.run(JaxSchedule.churn_storm(ticks, n, fraction=0.1, fail_tick=1, seed=1))
        ps = pmesh.ShardedStorm(n=n, mesh=pmesh.make_mesh(s, device="cpu"),
                                params=pes.ScalableParams(n=n, **kw), seed=1)
        pm = ps.run(StormSchedule.churn_storm(ticks, n, fraction=0.1, fail_tick=1, seed=1))
        want = np.asarray(jm.mean_heard_frac)
        assert (want != 1).sum() >= ticks // 2  # partial coverage: the mean is really summed
        assert np.array_equal(pm.mean_heard_frac, want), s


def test_sharded_mean_of_one_piece_is_the_single_device_mean():
    x = torch.rand(1000, generator=torch.Generator().manual_seed(3))
    assert torch.equal(pes.sharded_mean_f32([x]), pes._xla_mean_f32(x))
    # local lengths 4 and 8 sum in 4 lanes, folded in halves
    for rows in (4, 8):
        parts = list(torch.rand(3 * rows, generator=torch.Generator().manual_seed(rows)).split(rows))
        lanes = [p.reshape(-1, 4) for p in parts]
        want = None
        for q in lanes:
            acc = q[0].clone()
            for r in q[1:]:
                acc = acc + r
            part = (acc[0] + acc[2]) + (acc[1] + acc[3])
            want = part if want is None else want + part
        want = want * float(np.float32(1) / np.float32(3 * rows))
        assert torch.equal(pes.sharded_mean_f32(parts), want)


def test_state_layout():
    n, shards = 32, 8
    storm = pmesh.ShardedStorm(n=n, mesh=pmesh.make_mesh(shards, device="cpu"),
                               params=pes.ScalableParams(n=n, u=160, exchange_metrics=shards))
    sts = storm.shard_states
    assert len(sts) == shards
    for s, st in enumerate(sts):
        for f in pes.NODE_SHARDED_FIELDS:
            assert getattr(st, f).shape[0] == n // shards, f
        assert st.heard.shape == (n // shards, 160 // 32)
        # the rumor table, clock and rng are whole on every shard
        assert st.r_delta.shape == (160,) and st.rng.shape == (2,)
        assert torch.equal(st.r_delta, sts[0].r_delta)
        # the exchange telemetry: one counter row a shard
        assert st.exch.shape[0] == 1 and st.exch_hist.shape[0] == 1
    whole = storm.state
    assert whole.heard.shape == (n, 5) and whole.exch.shape[0] == shards
    assert storm.exchange_resolution()["devices"] == ["cpu"] * shards


def test_make_mesh_places_shards_where_asked():
    mesh = pmesh.make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.axis_names == ("nodes",) and mesh.shape == {"nodes": 4}
    assert all(d.type == "cpu" for d in mesh.devices)
    m2 = pmesh.make_mesh_2d(2, 4, device="cpu")
    assert m2.axis_names == ("dcn", "ici") and m2.shape == {"dcn": 2, "ici": 4} and m2.size == 8
    with pytest.raises(ValueError, match="exactly"):
        pmesh.make_mesh_2d(2, 4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        # the card is never swapped for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.ShardedStorm(n=16, params=pes.ScalableParams(n=16, u=128))


def test_partition_and_leave_like_jax(no_jax_cache):
    """Optional partition and leave inputs, step by step at 8 shards of 4
    rows (the 4-lane local mean), against JAX's ShardedStorm and the
    port's single-device cluster."""
    n, shards = 32, 8
    kw = dict(u=160, enable_leave=True, packet_loss=0.2)
    single = ScalableCluster(n=n, params=pes.ScalableParams(n=n, **kw), seed=6, device="cpu")
    storm = pmesh.ShardedStorm(n=n, mesh=pmesh.make_mesh(shards, device="cpu"),
                               params=pes.ScalableParams(n=n, **kw), seed=6)
    js = jmesh.ShardedStorm(n=n, mesh=jmesh.make_mesh(shards), params=jes.ScalableParams(n=n, **kw),
                            seed=6)
    part = np.zeros(n, np.int32)
    part[: n // 4] = 1
    lv = np.zeros(n, bool)
    lv[5] = True
    kill = np.zeros(n, bool)
    kill[9] = True
    quiet = dict(kill=np.zeros(n, bool), revive=np.zeros(n, bool))
    steps = ([dict(quiet, partition=part)] + [quiet] * 3 + [dict(quiet, kill=kill)]
             + [dict(quiet, leave=lv)] + [quiet] * 4 + [dict(quiet, partition=np.zeros(n, np.int32))]
             + [quiet] * 5 + [dict(quiet, revive=kill)] + [quiet] * 3)
    for t, inp in enumerate(steps):
        jm = js.step(jes.ChurnInputs(**{k: jax.numpy.asarray(v) for k, v in inp.items()}))
        pm = storm.step(pes.ChurnInputs(**inp))
        sm = single.step(pes.ChurnInputs(**{k: torch.as_tensor(v) for k, v in inp.items()}))
        _assert_metrics(jm, pm, "tick %d: " % t)
        _assert_metrics(sm, pm, "tick %d: " % t, skip=("mean_heard_frac",))
    _assert_state(_jax_state(js), storm.state)
    _assert_state(convert.scalable_state_to_numpy(single.state), storm.state)
    assert int(storm.state.truth_status[5]) == pes.LEAVE


def test_mesh_2d_equals_the_flat_mesh(storm64):
    """make_mesh_2d(2, 4) splits the node axis over both axes in order:
    the same shards as make_mesh(8), the same trajectory and mean."""
    n, ticks, kw = storm64["n"], storm64["ticks"], storm64["kw"]
    storm = pmesh.ShardedStorm(n=n, mesh=pmesh.make_mesh_2d(2, 4, device="cpu"),
                               params=pes.ScalableParams(n=n, **kw), seed=4)
    m = storm.run(StormSchedule(ticks=ticks, n=n, **_planes(ticks, n)))
    jm, jstate, _ = storm64["jax"][8]
    _assert_metrics(jm, m)
    _assert_state(jstate, storm.state)
