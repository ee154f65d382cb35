"""The port's ShardedSim: the full engine on the in-process shard mesh.

Held every tick (every ``SimState`` and ``TickMetrics`` field) against the
port's own ``SimCluster`` at 1, 2, 4 and 8 shards on JAX's schedule
(tests/parallel/test_mesh.py), in farmhash mode with the fused and the
classic checksum pipeline and ungated too; the 2x4 mesh against the flat
one; the full fault lifecycle; the bounded-parity overflow replay; the
fused-tick resolution against JAX's table; the refusals; the sharded
checkpoints across shard counts and both ways between the packages; and
one JAX ``ShardedSim`` run (n=32, eight XLA CPU devices) against the port
at eight shards.  The kernels' plain versions are held on shard tiles:
rows ``[lo, lo + R)`` equal those rows of the whole-plane call.  The
kernels themselves launch on their operands' card (a test parses every
launch site; a two-card test runs where two cards are visible).
"""

from __future__ import annotations

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine as jengine
from ringpop_tpu.models.sim.cluster import EventSchedule as JaxSchedule
from ringpop_tpu.parallel import mesh as jmesh
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.ops import _build, block_loop as pbl, fused_apply as pfa
from ringpop_tpu_torch.ops import fused_piggyback as pfp, stream_hash as psh, toolkit, u32
from ringpop_tpu_torch.parallel import ShardedSim, make_mesh, make_mesh_2d
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)
from tests.test_torch_mesh import no_jax_cache  # noqa: F401  (a fixture)

CPU = "cpu"
N = 32
TICKS = 12


def _kill_schedule(n=N, ticks=TICKS):
    """JAX's schedule: three nodes killed at tick 4."""
    kill = np.zeros((ticks, n), bool)
    kill[4, :3] = True
    return kill


def _state_np(state) -> dict:
    return {f: None if x is None else x.to(CPU).numpy() for f, x in zip(state._fields, state)}


def _assert_state(want: dict, got: dict, ctx: str) -> None:
    for f in pe.SimState._fields:
        a, b = want[f], got[f]
        assert (a is None and b is None) or np.array_equal(a, b), "%s: %s" % (ctx, f)


def _assert_metrics(want, got, ctx: str) -> None:
    for f in pe.TickMetrics._fields:
        assert np.array_equal(np.asarray(getattr(want, f)), np.asarray(getattr(got, f))), (ctx, f)


def _trajectory(sim, kill) -> list:
    """Bootstrap, then one step a row of ``kill``: each tick's metrics and
    whole state, as numpy."""
    out = [(sim.bootstrap(), _state_np(sim.state))]
    for row in kill:
        inp = pe.TickInputs.quiet(sim.params.n)._replace(kill=torch.as_tensor(row))
        out.append((sim.step(inp), _state_np(sim.state)))
    return out


def _assert_trajectory(want, got, ctx: str) -> None:
    assert len(want) == len(got)
    for t, ((mw, sw), (mg, sg)) in enumerate(zip(want, got)):
        _assert_metrics(mw, mg, "%s tick %d" % (ctx, t))
        _assert_state(sw, sg, "%s tick %d" % (ctx, t))


@pytest.fixture(scope="module")
def fast_twin():
    """The port's SimCluster on JAX's schedule, fast mode, seed 3."""
    p = pe.SimParams(n=N, checksum_mode="fast")
    return _trajectory(SimCluster(n=N, params=p, seed=3, device=CPU), _kill_schedule())


# ---------------------------------------------------------------------------
# ShardedSim == SimCluster


@pytest.mark.parametrize("shards", (1, 2, 4, 8))
def test_sharded_sim_equals_sim_cluster_every_tick(fast_twin, shards):
    p = pe.SimParams(n=N, checksum_mode="fast")
    sim = ShardedSim(N, make_mesh(shards, device=CPU), params=p, seed=3)
    assert len(sim.shard_states) == shards
    assert sim.shard_states[0].known.shape == (N // shards, N)
    _assert_trajectory(fast_twin, _trajectory(sim, _kill_schedule()), "S=%d" % shards)
    np.testing.assert_array_equal(sim.checksums(), u32.to_numpy(torch.as_tensor(
        fast_twin[-1][1]["checksum"])))


def test_ungated_mesh_equals_gated_cluster(fast_twin):
    """gate_phases=False runs every phase on every shard with no agreed
    predicate: the same trajectory."""
    p = pe.SimParams(n=N, checksum_mode="fast", gate_phases=False)
    sim = ShardedSim(N, make_mesh(4, device=CPU), params=p, seed=3)
    _assert_trajectory(fast_twin, _trajectory(sim, _kill_schedule()), "ungated")


@pytest.mark.parametrize("fused_checksum", ("on", "off"))
def test_farmhash_mesh_equals_sim_cluster_every_tick(fused_checksum):
    """Farmhash mode: the fused record cache and stream hash ("on"), the
    classic encode and block loop ("off", gated chunks of 5 rows that
    straddle the shards)."""
    p = pe.SimParams(n=N, checksum_mode="farmhash", fused_checksum=fused_checksum,
                     **({} if fused_checksum == "on" else dict(dirty_batch=5)))
    kill = _kill_schedule(ticks=8)
    want = _trajectory(SimCluster(n=N, params=p, seed=3, device=CPU), kill)
    sim = ShardedSim(N, make_mesh(4, device=CPU), params=p, seed=3)
    assert sim.params.fused_checksum == fused_checksum
    _assert_trajectory(want, _trajectory(sim, kill), "farmhash " + fused_checksum)


def test_2d_mesh_equals_flat_mesh():
    n = 16
    p = pe.SimParams(n=n, checksum_mode="fast")
    got = []
    for mesh in (make_mesh_2d(2, 4, device=CPU), make_mesh(8, device=CPU)):
        sim = ShardedSim(n, mesh, params=p, seed=5)
        got.append(_trajectory(sim, np.zeros((8, n), bool)))
    _assert_trajectory(got[1], got[0], "2x4")
    single = SimCluster(n=n, params=p, seed=5, device=CPU)
    _assert_trajectory(_trajectory(single, np.zeros((8, n), bool)), got[0], "2x4 vs single")


def _lifecycle(n):
    """JAX's full lifecycle (test_mesh.py:95): kill -> suspect -> expiry,
    revive -> reset + join, leave, rejoin, partition split and heal."""
    def ev(**kw):
        inp = pe.TickInputs.quiet(n)
        reps = {}
        for k, idx in kw.items():
            if k == "partition":
                reps[k] = torch.as_tensor(idx, dtype=torch.int32)
            else:
                v = np.zeros(n, bool)
                v[list(idx)] = True
                reps[k] = torch.as_tensor(v)
        return inp._replace(**reps)

    part = np.zeros(n, np.int32)
    part[:4] = 1
    heal = np.zeros(n, np.int32)
    return (
        [ev() for _ in range(4)] + [ev(kill=[2])] + [ev() for _ in range(28)]
        + [ev(revive=[2])] + [ev() for _ in range(6)] + [ev(leave=[5])]
        + [ev() for _ in range(4)] + [ev(join=[5])] + [ev(partition=part)]
        + [ev() for _ in range(6)] + [ev(partition=heal)] + [ev() for _ in range(10)]
    )


def test_full_lifecycle_sharded_equals_sim_cluster():
    n = 16
    p = pe.SimParams(n=n, checksum_mode="fast")
    sharded = ShardedSim(n, make_mesh(4, device=CPU), params=p, seed=9)
    single = SimCluster(n=n, params=p, seed=9, device=CPU)
    _assert_metrics(single.bootstrap(), sharded.bootstrap(), "bootstrap")
    for t, inp in enumerate(_lifecycle(n)):
        _assert_metrics(single.step(inp), sharded.step(inp), "lifecycle tick %d" % t)
        _assert_state(_state_np(single.state), _state_np(sharded.state), "lifecycle %d" % t)


@pytest.mark.parametrize("fused_checksum", ("on", "off"))
def test_bounded_overflow_replay_on_the_mesh(fused_checksum):
    """Bounded chunks too small for the churn: the whole cluster's counts
    decide the overflow, so the mesh replays exactly when SimCluster does,
    in step() and in run() alike, and lands on the same state."""
    n = 16
    p = pe.SimParams(n=n, checksum_mode="farmhash", fused_checksum=fused_checksum,
                     parity_recompute="bounded", dirty_batch=3, cell_batch=24)
    single = SimCluster(n=n, params=p, seed=2, device=CPU)
    sharded = ShardedSim(n, make_mesh(4, device=CPU), params=p, seed=2)
    _assert_metrics(single.bootstrap(), sharded.bootstrap(), "bootstrap")
    kill = np.zeros((6, n), bool)
    kill[1, :2] = True
    _assert_metrics(single.run(EventSchedule(ticks=6, n=n, kill=kill)),
                    sharded.run(EventSchedule(ticks=6, n=n, kill=kill)), "run")
    for _ in range(3):
        _assert_metrics(single.step(), sharded.step(), "step")
    assert sharded.parity_replays == single.parity_replays > 0
    _assert_state(_state_np(single.state), _state_np(sharded.state), "replayed")


@pytest.mark.parametrize("fused_checksum", ("on", "off"))
def test_overflowing_bounded_tick_is_the_single_devices_before_the_replay(fused_checksum):
    """The tick the replay discards is still the single device's: each
    shard recomputes its share of the whole cluster's first dirty rows
    (and changed cells), and the overflow counts are the cluster's."""
    n = 16
    p = pe.SimParams(n=n, checksum_mode="farmhash", fused_checksum=fused_checksum,
                     parity_recompute="bounded", dirty_batch=3, cell_batch=24)
    single = SimCluster(n=n, params=p, seed=6, device=CPU)
    sharded = ShardedSim(n, make_mesh(4, device=CPU), params=p, seed=6)
    boot = single.quiet_inputs()._replace(join=torch.ones(n, dtype=torch.bool))
    want_state, want = pe.tick(single.state, boot, single.params, single.universe)
    shard_inputs = sharded._shard_inputs({torch.device(CPU): list(boot)})
    states, got = sharded._tick(sharded.shard_states, shard_inputs, sharded.params)
    assert int(want.parity_overflow) > 0
    _assert_metrics(want, got, "overflowing tick")
    _assert_state(_state_np(want_state), _state_np(convert.join_sim_state(states, CPU)),
                  "overflowing tick")


# ---------------------------------------------------------------------------
# the resolution and the refusals


# (JAX request, backend, n) -> JAX's sharded pick, in JAX's terms; the
# port's device for a backend: the accelerator is the card
RESOLUTION_TABLE = {
    ("auto", "tpu", 32): "xla",
    ("auto", "tpu", 4096): "xla",
    ("pallas", "tpu", 32): "xla",
    ("pallas", "cpu", 32): "xla",
    ("xla", "tpu", 32): "xla",
    ("xla", "cpu", 32): "xla",
    ("off", "tpu", 32): "off",
    ("off", "cpu", 32): "off",
}
PORT_DEVICE = {"tpu": "cuda", "cpu": "cpu"}


@pytest.mark.parametrize("case", sorted(RESOLUTION_TABLE))
def test_sharded_fused_tick_resolution_is_jax_table(case):
    requested, backend, n = case
    want = RESOLUTION_TABLE[case]
    jp = jengine.SimParams(n=n, fused_tick=requested)
    assert jengine.resolve_sharded_fused_tick(jp, backend) == want
    pp = pe.SimParams(n=n, fused_tick=convert.FUSED_TICK_MAP[requested])
    assert pe.resolve_sharded_fused_tick(pp, PORT_DEVICE[backend]) == convert.FUSED_TICK_MAP[want]


def test_auto_on_the_cpu_keeps_the_ports_single_device_pick():
    """On the CPU the port's single-device "auto" is "plain" where JAX's is
    "off" below n=4096 (engine.resolve_fused_tick); the mesh keeps it."""
    assert jengine.resolve_sharded_fused_tick(jengine.SimParams(n=32), "cpu") == "off"
    assert pe.resolve_sharded_fused_tick(pe.SimParams(n=32), "cpu") == "plain"


def test_resolution_note_reports_port_and_jax_picks():
    sim = ShardedSim(16, make_mesh(4, device=CPU), params=pe.SimParams(n=16, fused_tick="plain"))
    note = sim.fused_tick_resolution()
    assert note == {
        "requested": "plain", "impl": "plain", "jax_impl": "plain",
        "single_device_resolution": "plain", "differs_from_single_device": False,
        "shards": 4, "devices": ["cpu"] * 4,
    }
    note["devices"].append("x")
    assert sim.fused_tick_resolution()["devices"] == ["cpu"] * 4


def test_indivisible_node_count_is_refused():
    with pytest.raises(ValueError, match="not divisible"):
        ShardedSim(18, make_mesh(4, device=CPU), params=pe.SimParams(n=18))


def test_split_and_join_sim_state_round_trip():
    p = pe.SimParams(n=16, checksum_mode="farmhash", fused_checksum="on")
    sim = SimCluster(n=16, params=p, device=CPU)
    parts = convert.split_sim_state(sim.state, [CPU] * 4)
    assert parts[1].rec_bytes.shape[:2] == (4, 16) and parts[1].tick_index.dim() == 0
    _assert_state(_state_np(sim.state), _state_np(convert.join_sim_state(parts, CPU)), "join")
    with pytest.raises(ValueError, match="not divisible"):
        convert.split_sim_state(sim.state, [CPU] * 3)


# ---------------------------------------------------------------------------
# checkpoints across shard counts, and one JAX ShardedSim run


def _halves(n=N):
    kill = _kill_schedule(n)
    return kill[:TICKS // 2], kill[TICKS // 2:]


@pytest.fixture(scope="module")
def jax_runs(no_jax_cache, tmp_path_factory):  # noqa: F811
    """One JAX ShardedSim (n=32, fast, eight devices) and the port's at
    eight shards on JAX's schedule in two six-tick windows, each saving
    an eight-shard manifest between them; then the port's manifest loaded
    into the same JAX ShardedSim and its second window run again."""
    d = tmp_path_factory.mktemp("sharded_sim")
    first, second = _halves()
    jp = jengine.SimParams(n=N, checksum_mode="fast")
    jsim = jmesh.ShardedSim(n=N, mesh=jmesh.make_mesh(8), params=jp, seed=3)
    out = {"jax_boot": jsim.bootstrap()}
    out["jax_m1"] = jsim.run(JaxSchedule(ticks=6, n=N, kill=first.copy()))
    jsim.save(str(d / "jax"))
    out["jax_m2"] = jsim.run(JaxSchedule(ticks=6, n=N, kill=second.copy()))
    out["jax_final"] = {f: np.asarray(getattr(jsim.state, f)) for f in jsim.state._fields
                        if getattr(jsim.state, f) is not None}

    psim = ShardedSim(N, make_mesh(8, device=CPU), params=pe.SimParams(n=N, checksum_mode="fast"),
                      seed=3)
    out["port_boot"] = psim.bootstrap()
    out["port_m1"] = psim.run(EventSchedule(ticks=6, n=N, kill=first))
    psim.save(str(d / "port"))
    out["port_m2"] = psim.run(EventSchedule(ticks=6, n=N, kill=second))
    out["port_final"] = _state_np(psim.state)
    out["port_final_u32"] = convert.state_to_numpy(psim.state)

    jsim.load(str(d / "port"))
    out["jax_m2_from_port"] = jsim.run(JaxSchedule(ticks=6, n=N, kill=second.copy()))
    out["jax_final_from_port"] = {f: np.asarray(getattr(jsim.state, f))
                                  for f in out["jax_final"]}
    out["dir"] = d
    return out


def _assert_jax_state(jax_state: dict, port: dict, ctx: str) -> None:
    """JAX's fields against the port's (uint32 fields as uint32)."""
    assert set(jax_state) == {f for f, a in port.items() if a is not None}
    for f, a in jax_state.items():
        assert np.array_equal(a, port[f]), "%s: %s" % (ctx, f)


def test_port_mesh_equals_jax_sharded_sim(jax_runs):
    for tag in ("boot", "m1", "m2"):
        _assert_metrics(jax_runs["jax_" + tag], jax_runs["port_" + tag], tag)
    _assert_jax_state(jax_runs["jax_final"], jax_runs["port_final_u32"], "final")


def test_port_manifest_finishes_bitwise_in_jax_sharded_sim(jax_runs):
    _assert_metrics(jax_runs["jax_m2"], jax_runs["jax_m2_from_port"], "jax resumed")
    _assert_jax_state(jax_runs["jax_final_from_port"], jax_runs["port_final_u32"], "jax resumed")


@pytest.mark.parametrize("src", ("jax", "port"))
@pytest.mark.parametrize("resume", (2, 4, "cluster"))
def test_manifest_resumes_across_shard_counts(jax_runs, src, resume):
    """An eight-shard manifest from either package resumes on 2 or 4
    shards or on SimCluster and finishes bitwise."""
    p = pe.SimParams(n=N, checksum_mode="fast")
    if resume == "cluster":
        sim = SimCluster(n=N, params=p, seed=11, device=CPU)
    else:
        sim = ShardedSim(N, make_mesh(resume, device=CPU), params=p, seed=11)
    sim.load(str(jax_runs["dir"] / src))
    m2 = sim.run(EventSchedule(ticks=6, n=N, kill=_halves()[1]))
    _assert_metrics(jax_runs["port_m2"], m2, "%s -> %s" % (src, resume))
    _assert_state(jax_runs["port_final"], _state_np(sim.state), "%s -> %s" % (src, resume))


def test_cadence_and_restore_latest(tmp_path):
    n = 16
    p = pe.SimParams(n=n, checksum_mode="fast")
    sim = ShardedSim(n, make_mesh(4, device=CPU), params=p, seed=4)
    mgr = sim.enable_checkpoints(str(tmp_path), every=3, keep=2)
    assert mgr.shards == 4
    sim.bootstrap()
    sim.run(EventSchedule(ticks=7, n=n))
    want = _state_np(sim.state)
    twin = ShardedSim(n, make_mesh(2, device=CPU), params=p, seed=99)
    twin.enable_checkpoints(str(tmp_path), every=0)
    assert twin.restore_latest() == 6
    twin.step()
    twin.step()
    _assert_state(want, _state_np(twin.state), "restored")


# ---------------------------------------------------------------------------
# the kernels' plain versions on shard tiles


def _apply_operands(n, seed):
    rng = np.random.default_rng(seed)
    t = torch.as_tensor
    st = pfa.ApplyState(
        known=t(rng.random((n, n)) < 0.7), status=t(rng.integers(0, 4, (n, n), dtype=np.int32)),
        inc=t(rng.integers(0, 9, (n, n), dtype=np.int32)), ch_active=t(rng.random((n, n)) < 0.3),
        ch_status=t(rng.integers(0, 4, (n, n), dtype=np.int32)),
        ch_inc=t(rng.integers(0, 9, (n, n), dtype=np.int32)),
        ch_source=t(rng.integers(-1, n, (n, n), dtype=np.int32)),
        ch_source_inc=t(rng.integers(0, 9, (n, n), dtype=np.int32)),
        ch_pb=t(rng.integers(0, 5, (n, n), dtype=np.int32)),
        susp_deadline=t(rng.integers(-1, 30, (n, n), dtype=np.int32)),
    )
    # self cells get a suspect/faulty update often, so refutes happen
    status = rng.integers(0, 4, (n, n), dtype=np.int32)
    status[np.eye(n, dtype=bool)] = rng.integers(1, 3, n)
    upd = (t(rng.random((n, n)) < 0.6), t(status), t(rng.integers(0, 12, (n, n), dtype=np.int32)),
           t(rng.integers(0, n, (n, n), dtype=np.int32)),
           t(rng.integers(0, 9, (n, n), dtype=np.int32)))
    union = u32.from_numpy(rng.integers(0, 2**32, (n, toolkit.packed_width(n)), dtype=np.uint32),
                           CPU)
    return st, upd, union


TILES = ((0, 16), (16, 16), (24, 8), (40, 8))  # (lo, rows) of a 48-node cluster


@pytest.mark.parametrize("lo,rows", TILES)
def test_apply_updates_tile_equals_whole_plane_rows(lo, rows):
    n = 48
    st, upd, union = _apply_operands(n, seed=lo + rows)
    kw = dict(want_masks=True, want_count=True, want_refute=True)
    whole = pfa.apply_updates(st, *upd, 41, 47, union, **kw)
    sl = slice(lo, lo + rows)
    tile = pfa.apply_updates(pfa.ApplyState(*(x[sl] for x in st)), *(x[sl] for x in upd), 41, 47,
                             union[sl], lo=lo, **kw)
    for a, b in zip(tile.state, whole.state):
        assert torch.equal(a, b[sl])
    assert torch.equal(tile.union, whole.union[sl])
    assert torch.equal(tile.applied, whole.applied[sl])
    assert torch.equal(tile.applied_rows, whole.applied_rows[sl])
    assert torch.equal(tile.refute_diag, whole.refute_diag[sl])
    assert bool(tile.refute_diag.any())
    assert int(tile.applied_count) == int(whole.applied[sl].sum())


def test_apply_updates_tiles_under_vmap_and_refusals():
    """The batching rule takes the row offset too; a tile past the last
    node is refused."""
    n, lo, rows = 48, 24, 8
    ops = [_apply_operands(n, seed=s) for s in (1, 2)]
    sl = slice(lo, lo + rows)

    def one(*planes):
        out = pfa.apply_updates(pfa.ApplyState(*planes[:10]), *planes[10:], 41, 47, lo=lo,
                                want_refute=True)
        return (*out.state, out.applied_rows, out.refute_diag)

    stacked = [torch.stack([(tuple(o[0]) + o[1])[i][sl] for o in ops]) for i in range(15)]
    got = torch.func.vmap(one)(*stacked)
    for b, (st, upd, _) in enumerate(ops):
        want = pfa.apply_updates_plain(pfa.ApplyState(*(x[sl] for x in st)),
                                       *(x[sl] for x in upd), 41, 47, lo=lo)
        for g, w in zip(got, (*want.state, want.applied_rows, want.refute_diag)):
            assert torch.equal(g[b], w)
    st, upd, _ = ops[0]
    with pytest.raises(ValueError, match="outside"):
        pfa.apply_updates(pfa.ApplyState(*(x[sl] for x in st)), *(x[sl] for x in upd), 41, 47,
                          lo=n - 4)


@pytest.mark.parametrize("lo,rows", TILES)
def test_pb_budget_tile_equals_whole_plane_rows(lo, rows):
    n = 48
    rng = np.random.default_rng(lo)
    t = torch.as_tensor
    args = (t(rng.random((n, n)) < 0.5), t(rng.integers(0, 40, (n, n), dtype=np.int32)),
            t(rng.integers(0, 4, n, dtype=np.int32)), t(rng.integers(15, 50, n, dtype=np.int32)),
            t(rng.integers(0, 2, (n, n), dtype=np.int32)))
    sl = slice(lo, lo + rows)
    whole = pfp.pb_budget(*args)
    tile = pfp.pb_budget(*(x[sl] for x in args))
    for a, b in zip(tile[:3], whole[:3]):
        assert torch.equal(a, b[sl])
    over = whole.ch_active != args[0]
    assert int(tile.drops) == int(over[sl].sum())


def test_hash_loops_tile_equals_whole_rows(monkeypatch):
    """fused_stream and block_loop hash each row on its own: rows [lo, lo +
    R) of the whole call are the call on those rows (fused_stream through
    the fused pipeline's row hash, with its real operands kept)."""
    from ringpop_tpu_torch.ops import fused_checksum as fc

    p = pe.SimParams(n=24, checksum_mode="farmhash", fused_checksum="on")
    sim = SimCluster(n=24, params=p, seed=1, device=CPU)
    sim.bootstrap()
    st = sim.state
    kept, real = [], psh.fused_stream
    monkeypatch.setattr(psh, "fused_stream", lambda *a: kept.append(a) or real(*a))
    fc.fused_hash_rows(fc.pack_record_words(st.rec_bytes), st.rec_len)
    (args,) = kept
    whole = real(*args)
    rng = np.random.default_rng(5)
    h0, g0, f0 = (u32.from_numpy(rng.integers(0, 2**32, 24, dtype=np.uint32), CPU)
                  for _ in range(3))
    blocks = u32.from_numpy(rng.integers(0, 2**32, (24, 7, 5), dtype=np.uint32), CPU)
    iters = torch.as_tensor(rng.integers(0, 8, 24, dtype=np.int32))
    whole_bl = pbl.block_loop(h0, g0, f0, blocks, iters)
    for lo, rows in ((0, 8), (8, 8), (12, 12)):
        sl = slice(lo, lo + rows)
        tile = real(*(a[sl] for a in args))
        for a, b in zip(tile, whole):
            assert torch.equal(a, b[sl])
        tile_bl = pbl.block_loop(h0[sl], g0[sl], f0[sl], blocks[sl], iters[sl])
        for a, b in zip(tile_bl, whole_bl):
            assert torch.equal(a, b[sl])
        # the engine's row recompute on a tile: the tile's rows of the whole
        np.testing.assert_array_equal(
            u32.to_numpy(pe.compute_checksums(st._replace(
                known=st.known[sl], status=st.status[sl], inc=st.inc[sl]), sim.universe,
                sim.params._replace(fused_checksum="off"))),
            u32.to_numpy(pe.compute_checksums(st, sim.universe,
                                              sim.params._replace(fused_checksum="off")))[sl])


# ---------------------------------------------------------------------------
# the kernels launch on their operands' card


def test_every_kernel_launch_names_its_card():
    """Every ``library().call(...)`` under ops/ passes the operands' device
    second (``KernelLibrary.call`` sets that card and takes its stream)."""
    params = list(inspect.signature(_build.KernelLibrary.call).parameters)
    assert params[:4] == ["self", "name", "device", "ptrs"]
    ops = Path(_build.__file__).parent
    sites = 0
    for path in sorted(ops.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "call" and isinstance(node.func.value, ast.Call)
                    and getattr(node.func.value.func, "attr", None) == "library"):
                sites += 1
                assert len(node.args) >= 3, "%s:%d" % (path.name, node.lineno)
                device = node.args[1]
                assert isinstance(device, (ast.Name, ast.Attribute)), \
                    "%s:%d passes no device" % (path.name, node.lineno)
    # one launch site for each entry point of the library
    assert sites == len(_build.ENTRY_POINTS) == 11


@pytest.mark.cuda
def test_second_card_equals_first_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    p = pe.SimParams(n=64, checksum_mode="farmhash")
    runs = []
    for dev in ("cuda:0", "cuda:1"):
        sim = SimCluster(n=64, params=p, seed=7, device=dev)
        sim.bootstrap()
        kill = np.zeros((8, 64), bool)
        kill[2, :6] = True
        runs.append((sim.run(EventSchedule(ticks=8, n=64, kill=kill)), _state_np(sim.state)))
    _assert_metrics(runs[0][0], runs[1][0], "cuda:1")
    _assert_state(runs[0][1], runs[1][1], "cuda:1")
