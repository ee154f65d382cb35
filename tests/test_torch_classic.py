"""The port's classic tick (``fused_tick="off"``) and unfused farmhash
checksum path (``fused_checksum="off"``) against the JAX engine, bit for
bit, tick by tick.

Both engines start from one state and run the n=64 churn schedule of
tests/test_torch_engine.py (a bootstrap tick, then kills, a revive, a
graceful leave and a rejoin, ``suspicion_ticks=6``); every SimState field
and every TickMetrics field must be equal on every tick, with JAX's
``hash_impl="scan"`` against the port's "plain".  Configurations: the
classic unfused tick under the "gated" and "full" recompute shapes with
``gate_phases`` True and False; the classic tick in fast mode; the fused
tick's plain versions with the unfused checksums; the classic tick with the
fused checksum pipeline.  Also: bounded-shape overflow replay equals the
exact run, an unfused ``init_state`` carries no record cache on either
side, lockstep with the host oracle at n=16, and ``convert`` on an unfused
state and on the JAX knobs.
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
from ringpop_tpu.parity import OracleCluster
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.cluster import SimCluster
from ringpop_tpu_torch.ops import checksum_encode as pce
from tests.test_torch_engine import _assert_state_equal, _events, _port_schedule
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

N = 64
TICKS = 32


@pytest.fixture(scope="module")
def universes():
    addrs = default_addresses(N)
    return jce.Universe.from_addresses(addrs), pce.Universe.from_addresses(addrs)


def _jax_params(fused_tick, fused_checksum, shape, gate, mode="farmhash"):
    return je.SimParams(
        n=N,
        checksum_mode=mode,
        suspicion_ticks=6,
        gate_phases=gate,
        fused_tick=fused_tick,
        fused_checksum=fused_checksum,
        hash_impl="scan",
        parity_recompute=shape,
        dirty_batch=min(N, 1024) if shape == "bounded" else 256,
    )


def _carry_state(js, pp):
    return convert.state_from_numpy(
        {f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
         for f in je.SimState._fields},
        pp,
    )


CONFIGS = [
    # (fused_tick, fused_checksum, parity_recompute, gate_phases, checksum_mode)
    ("off", "off", "gated", True, "farmhash"),
    ("off", "off", "gated", False, "farmhash"),
    ("off", "off", "full", True, "farmhash"),
    ("off", "off", "full", False, "farmhash"),
    ("off", "off", "auto", True, "fast"),
    ("xla", "off", "gated", True, "farmhash"),
    ("off", "on", "bounded", True, "farmhash"),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(str(x) for x in c))
def test_classic_tick_bitwise_equal_to_jax_every_tick(universes, cfg):
    ju, pu = universes
    ft, fcs, shape, gate, mode = cfg
    jp = _jax_params(ft, fcs, shape, gate, mode)
    pp = convert.params_from_jax_fields(jp._asdict())
    assert (pp.fused_tick, pp.fused_checksum, pp.parity_recompute, pp.hash_impl) == (
        {"off": "off", "xla": "plain"}[ft], fcs, shape, "plain"
    )
    js = je.init_state(jp, seed=1, universe=ju)
    ps = _carry_state(js, pp)
    jtick = jax.jit(lambda s, i: je.tick(s, i, jp, ju))
    totals = dict.fromkeys(("suspects_marked", "faulties_marked", "refutes", "ping_reqs",
                            "dirty_rows"), 0)
    for t, ev in enumerate(_events(N, TICKS)):
        js, jm = jtick(js, je.TickInputs(**{k: jnp.asarray(v) for k, v in ev.items()}))
        ps, pm = pe.tick(ps, pe.TickInputs(**{k: torch.as_tensor(v) for k, v in ev.items()}),
                         pp, pu)
        label = "%s tick %d" % (cfg, t)
        _assert_state_equal(js, ps, label)
        for f in pe.TickMetrics._fields:
            want, got = np.asarray(getattr(jm, f)), getattr(pm, f).numpy()
            assert got.shape == () and int(got) == int(want), "%s: metric %s" % (label, f)
        for f in totals:
            totals[f] += int(getattr(pm, f))
    assert all(v > 0 for v in totals.values()), totals


def test_unfused_init_state_has_no_record_cache(universes):
    ju, pu = universes
    jp = _jax_params("off", "off", "gated", True)
    pp = convert.params_from_jax_fields(jp._asdict())
    js = je.init_state(jp, seed=3, universe=ju)
    ps = pe.init_state(pp, seed=3, universe=pu)
    assert js.rec_bytes is None and js.rec_len is None
    assert ps.rec_bytes is None and ps.rec_len is None
    _assert_state_equal(js, ps, "init")


def test_bounded_overflow_replay_equals_gated():
    """dirty_batch=8 overflows on the bootstrap and churn ticks; the cluster
    replays those windows under "gated" and ends bitwise equal to a run
    that used "gated" throughout."""
    n = 32
    base = pe.SimParams(n=n, checksum_mode="farmhash", suspicion_ticks=6, fused_tick="off",
                        fused_checksum="off")
    bounded = SimCluster(n=n, params=base._replace(parity_recompute="bounded", dirty_batch=8),
                         seed=1, device="cpu")
    exact = SimCluster(n=n, params=base, seed=1, device="cpu")
    assert bounded._exact_params().parity_recompute == "gated"
    assert exact.params.parity_recompute == "gated"
    sched = _port_schedule(n, 16)
    mb0, me0 = bounded.bootstrap(), exact.bootstrap()
    mb, me = bounded.run(sched), exact.run(sched)
    assert bounded.parity_replays >= 2 and exact.parity_replays == 0
    for f in pe.TickMetrics._fields:
        assert np.array_equal(getattr(mb0, f), getattr(me0, f)), f
        assert np.array_equal(getattr(mb, f), getattr(me, f)), f
    for f in pe.SimState._fields:
        a, b = getattr(bounded.state, f), getattr(exact.state, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_classic_lockstep_with_oracle_n16():
    """The classic unfused gated configuration against the host object
    oracle on the kill -> suspect -> faulty scenario of
    tests/test_torch_parity.py: checksums and ``converged`` every tick."""
    n = 16
    sim = SimCluster(n=n, params=pe.SimParams(n=n, checksum_mode="farmhash", fused_tick="off",
                                              fused_checksum="off"), device="cpu")
    assert (sim.params.fused_tick, sim.params.fused_checksum, sim.params.parity_recompute) == (
        "off", "off", "gated")
    oracle = OracleCluster(je.SimParams(n=n, checksum_mode="farmhash"), default_addresses(n),
                           seed=0)
    kill = np.zeros(n, bool)
    kill[5] = True
    schedule = [{"join": np.ones(n, bool)}] + [{}] * 6 + [{"kill": kill}] + [{}] * 40
    for t, ev in enumerate(schedule):
        m = sim.step(sim.quiet_inputs()._replace(**{k: torch.as_tensor(v) for k, v in ev.items()}))
        res = oracle.tick(ev)
        assert np.array_equal(sim.checksums(), res.checksums), "tick %d" % t
        assert bool(m.converged) == res.converged, "tick %d" % t
    assert len(sim.checksum_groups()) == 1


def test_convert_unfused_state_and_knobs():
    sim = SimCluster(n=16, params=pe.SimParams(n=16, fused_tick="off", fused_checksum="off"),
                     device="cpu")
    sim.bootstrap()
    arrays = convert.state_to_numpy(sim.state)
    assert arrays["rec_bytes"] is None and arrays["rec_len"] is None
    back = convert.state_from_numpy(arrays, sim.params)
    for f in pe.SimState._fields:
        a, b = getattr(back, f), getattr(sim.state, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    # a fused state still needs its record cache
    with pytest.raises(ValueError, match="record cache"):
        convert.state_from_numpy(arrays, sim.params._replace(fused_checksum="on"))
    for jft, pft in (("off", "off"), ("xla", "plain"), ("pallas", "kernel"), ("auto", "auto")):
        assert convert.params_from_jax_fields(
            je.SimParams(n=8, fused_tick=jft)._asdict()).fused_tick == pft
    for jh, ph in (("scan", "plain"), ("pallas", "kernel"), ("pallas_nogrid", "kernel"),
                   ("env", "auto")):
        assert convert.params_from_jax_fields(
            je.SimParams(n=8, hash_impl=jh)._asdict()).hash_impl == ph
    for shape in ("auto", "gated", "bounded", "full"):
        assert convert.params_from_jax_fields(
            je.SimParams(n=8, parity_recompute=shape)._asdict()).parity_recompute == shape
    for fcs in ("auto", "on", "off"):
        assert convert.params_from_jax_fields(
            je.SimParams(n=8, fused_checksum=fcs)._asdict()).fused_checksum == fcs
