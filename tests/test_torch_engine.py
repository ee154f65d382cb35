"""The port's engine against the JAX engine, tick by tick, bit for bit.

Both engines start from one state (``init_state`` draws the same numpy
randomness; the JAX state is also carried across through
``ringpop_tpu_torch.convert``) and run the n=64 churn schedule of
tests/models/test_fused_tick.py — kills, a revive, a graceful leave and a
rejoin, ``suspicion_ticks=6`` — after a bootstrap tick, in fast and
farmhash modes with ``gate_phases`` True and False.  Every SimState field
and every TickMetrics field must be equal on every tick (metrics by value:
the JAX package runs with x64 on, so some come out int64 there).  The JAX
side runs its CPU production shapes: the fused tick's XLA twins and the
scanned stream-hash twin.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.models.sim.cluster import default_addresses
from ringpop_tpu.ops import checksum_encode as jce
from ringpop_tpu_torch import convert, resolve_device
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster, _tick_at
from ringpop_tpu_torch.ops import checksum_encode as pce
from tests.models.test_fused_tick import _schedule
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

N = 64
TICKS = 32

_DTYPES = {
    "tick_index": torch.int32, "proc_alive": torch.bool, "ready": torch.bool,
    "gossip_on": torch.bool, "partition": torch.int32, "known": torch.bool,
    "ch_active": torch.bool, "rec_bytes": torch.uint8,
}


def _jax_params(mode, gate, n=N):
    return je.SimParams(
        n=n,
        checksum_mode=mode,
        suspicion_ticks=6,
        gate_phases=gate,
        fused_tick="xla",
        fused_checksum="on" if mode == "farmhash" else "off",
        hash_impl="scan",  # the JAX engine's scanned stream-hash twin
        parity_recompute="bounded" if mode == "farmhash" else "auto",
        dirty_batch=min(n, 1024),
    )


def _events(n, ticks):
    """Per-tick event dicts: a bootstrap tick, then the churn schedule."""
    sched = _schedule(n, ticks)
    evs = [dict(kill=np.zeros(n, bool), revive=np.zeros(n, bool), join=np.ones(n, bool),
                partition=np.full(n, -1, np.int32), leave=np.zeros(n, bool))]
    for t in range(ticks):
        evs.append(dict(kill=sched.kill[t], revive=sched.revive[t], join=sched.join[t],
                        partition=sched.partition[t], leave=sched.leave[t]))
    return evs


def _port_schedule(n, ticks):
    sched = _schedule(n, ticks)
    return EventSchedule(ticks=ticks, n=n, kill=sched.kill, revive=sched.revive,
                         join=sched.join, partition=sched.partition, leave=sched.leave)


def _assert_state_equal(js, ps, label):
    got = convert.state_to_numpy(ps)
    for f in pe.SimState._fields:
        want = getattr(js, f)
        if want is None:
            assert got[f] is None, (label, f)
            continue
        assert np.array_equal(got[f], np.asarray(want)), "%s: state field %s differs" % (label, f)
        t = getattr(ps, f)
        assert t.dtype == _DTYPES.get(f, torch.int32), (label, f, t.dtype)


@pytest.fixture(scope="module")
def universes():
    addrs = default_addresses(N)
    return jce.Universe.from_addresses(addrs), pce.Universe.from_addresses(addrs)


@pytest.mark.parametrize("mode", ["fast", "farmhash"])
def test_init_state_matches_jax(universes, mode):
    ju, pu = universes
    jp = _jax_params(mode, True)
    pp = convert.params_from_jax_fields(jp._asdict())
    _assert_state_equal(
        je.init_state(jp, seed=1, universe=ju), pe.init_state(pp, seed=1, universe=pu), "init"
    )


@pytest.mark.parametrize("mode,gate", [("fast", True), ("fast", False),
                                       ("farmhash", True), ("farmhash", False)])
def test_tick_bitwise_equal_to_jax_every_tick(universes, mode, gate):
    ju, pu = universes
    jp = _jax_params(mode, gate)
    pp = convert.params_from_jax_fields(jp._asdict())
    assert pp.gate_phases is gate and pp.checksum_mode == mode
    js = je.init_state(jp, seed=1, universe=ju)
    # carry the JAX state across instead of re-seeding the port's
    ps = convert.state_from_numpy(
        {f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
         for f in je.SimState._fields},
        pp,
    )
    jtick = jax.jit(lambda s, i: je.tick(s, i, jp, ju))
    totals = dict.fromkeys(("suspects_marked", "faulties_marked", "refutes", "ping_reqs"), 0)
    for t, ev in enumerate(_events(N, TICKS)):
        js, jm = jtick(js, je.TickInputs(**{k: jnp.asarray(v) for k, v in ev.items()}))
        ps, pm = pe.tick(ps, pe.TickInputs(**{k: torch.as_tensor(v) for k, v in ev.items()}),
                         pp, pu)
        label = "%s gate=%s tick %d" % (mode, gate, t)
        _assert_state_equal(js, ps, label)
        for f in pe.TickMetrics._fields:
            want, got = np.asarray(getattr(jm, f)), getattr(pm, f).numpy()
            assert got.shape == () and int(got) == int(want), "%s: metric %s" % (label, f)
        for f in totals:
            totals[f] += int(getattr(pm, f))
    # the schedule really churned: every kind of site fired
    assert all(v > 0 for v in totals.values()), totals


@pytest.mark.parametrize("mode", ["fast", "farmhash"])
def test_step_equals_run(mode):
    p = pe.SimParams(n=N, checksum_mode=mode, suspicion_ticks=6)
    sched = _port_schedule(N, 12)
    a = SimCluster(n=N, params=p, seed=1, device="cpu")
    a.bootstrap()
    ma = a.run(sched)
    b = SimCluster(n=N, params=p, seed=1, device="cpu")
    b.bootstrap()
    inputs = sched.as_inputs("cpu")
    mb = [b.step(_tick_at(inputs, t)) for t in range(12)]
    for f in pe.SimState._fields:
        va, vb = getattr(a.state, f), getattr(b.state, f)
        assert (va is None and vb is None) or torch.equal(va, vb), f
    for f in pe.TickMetrics._fields:
        assert np.array_equal(getattr(ma, f), np.array([getattr(m, f) for m in mb])), f


def test_bounded_overflow_replay_equals_full():
    """A small cell_batch overflows on the bootstrap and churn ticks; the
    cluster must replay those windows under "full" and end bitwise equal to
    a run that used "full" throughout."""
    n = 32
    base = pe.SimParams(n=n, checksum_mode="farmhash", suspicion_ticks=6)
    bounded = SimCluster(n=n, params=base._replace(parity_recompute="bounded", cell_batch=16),
                         seed=1, device="cpu")
    full = SimCluster(n=n, params=base._replace(parity_recompute="full"), seed=1, device="cpu")
    assert bounded.params.parity_recompute == "bounded"
    sched = _port_schedule(n, 16)
    for sim in (bounded, full):
        sim.bootstrap()
    mb, mf = bounded.run(sched), full.run(sched)
    assert bounded.parity_replays >= 2 and full.parity_replays == 0
    for f in pe.SimState._fields:
        x, y = getattr(bounded.state, f), getattr(full.state, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    for f in pe.TickMetrics._fields:
        assert np.array_equal(getattr(mb, f), getattr(mf, f)), f


def test_cluster_inspection_and_faults():
    from ringpop_tpu_torch.ops import farmhash32

    sim = SimCluster(n=16, params=pe.SimParams(n=16, checksum_mode="farmhash"), device="cpu")
    sim.bootstrap()
    assert sim.run_until_converged(max_ticks=40) > 0
    assert len(sim.checksum_groups()) == 1
    for i in (0, 7):
        assert farmhash32.hash32(sim.checksum_string_of(i)) == int(sim.checksums()[i])
    sim.leave([3])
    sim.partition([0] * 8 + [1] * 8)
    sim.kill([5])
    sim.revive([5])
    sim.rejoin([3])
    assert sim.membership_of(0)[0]["address"] == "127.0.0.1:3000"


def test_entry_points_refuse_to_fall_back():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SimCluster(n=8)
    for knob in ("fused_tick", "hash_impl"):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            SimCluster(n=8, params=pe.SimParams(n=8, **{knob: "kernel"}), device="cpu")
    # the obs planes are ported: they construct on the CPU with their fields
    for plane, fields in ((dict(flight_recorder=True), ("ev_buf", "first_heard")),
                          (dict(histograms=True), ("hist",))):
        sim = SimCluster(n=8, params=pe.SimParams(n=8, **plane), device="cpu")
        assert all(getattr(sim.state, f) is not None for f in fields), plane


def test_convert_roundtrip_and_params():
    jp = _jax_params("farmhash", False)
    pp = convert.params_from_jax_fields(jp._asdict())
    for f in convert.PROTOCOL_FIELDS:
        assert getattr(pp, f) == getattr(jp, f), f
    assert pp.fused_tick == "plain" and pp.hash_impl == "plain"
    assert pp.parity_recompute == "bounded" and pp.fused_checksum == "on"
    sim = SimCluster(n=16, params=pe.SimParams(n=16), device="cpu")
    sim.bootstrap()
    arrays = convert.state_to_numpy(sim.state)
    assert arrays["rng"].dtype == np.uint32 and arrays["checksum"].dtype == np.uint32
    back = convert.state_from_numpy(arrays, sim.params)
    for f in pe.SimState._fields:
        if getattr(sim.state, f) is None:  # a plane that is off
            assert getattr(back, f) is None, f
            continue
        assert torch.equal(getattr(back, f), getattr(sim.state, f)), f
