"""The scalable engine on a quiet, lossy network: the ``ping_req`` span
and the ``gate.open`` counter of the span log, the
lossy cluster's benchmark driver and judge (``portbench/drivers/
epidemic.py``, ``portbench/reference/epidemic.py``) with faults planted
under them, and the port against the JAX engine at SWIM's 25-tick
suspicion."""

from __future__ import annotations

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.obs import perf
from ringpop_tpu_torch.ops import prp_walk as prp
from ringpop_tpu_torch.parallel.mesh import ShardedStorm, make_mesh
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the gated sites of a tick without leave: aging, ping-req, the checksum
# diff, the suspect / faulty / alive publishes, coverage, distinct views
GATED_SITES = 8


def _lossy(n, loss=0.05, **kw):
    return es.ScalableParams(n=n, u=256, suspicion_ticks=25, packet_loss=loss, **kw)


def _traced(fn):
    timer = perf.DispatchTimer()
    with perf.tracing(timer):
        out = fn()
    return out, timer


def _assert_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        else:
            assert np.array_equal(x, y), f


def _site_reads(monkeypatch):
    """Record every agreed read of the single-card tick as (the innermost
    open span when it was made, its value)."""
    reads = []
    orig = es.host_read

    def noted(pred):
        site = next(r[0] for r in reversed(perf.active().log) if r[2] is None)
        value = orig(pred)
        reads.append((site, value))
        return value

    noted.count = orig.count  # the read counts itself under its module name
    monkeypatch.setattr(es, "host_read", noted)
    return reads


def test_ping_req_span_in_a_lossy_tick_inside_exchange():
    n = 256
    sim = ScalableCluster(n, params=_lossy(n, loss=0.2), replica_points=4, seed=1, device=CPU)
    _, timer = _traced(lambda: sim.run(StormSchedule(ticks=3, n=n)))
    log = timer.log
    spans = [i for i, r in enumerate(log) if r[0] == "ping_req"]
    assert len(spans) == 3
    for i in spans:
        assert log[log[i][3]][0] == "exchange" and log[i][1] <= log[i][2]


def test_no_ping_req_span_in_a_quiet_loss_free_gated_tick():
    n = 256
    sim = ScalableCluster(n, params=_lossy(n, loss=0.0), replica_points=4, seed=1, device=CPU)
    sim.run(StormSchedule(ticks=2, n=n))
    _, timer = _traced(lambda: sim.run(StormSchedule(ticks=3, n=n)))
    names = {r[0] for r in timer.log}
    assert "exchange" in names and "ping_req" not in names
    # the fanout's gate stayed shut: no gated phase that ran was it
    assert timer.counters.get("gate.open", 0) < 3 * GATED_SITES


@pytest.mark.parametrize("n,loss", [(400, 0.05), (256, 0.2)])
def test_gate_open_counts_the_gated_phases_that_ran(monkeypatch, n, loss):
    sim = ScalableCluster(n, params=_lossy(n, loss=loss), replica_points=4, seed=2, device=CPU)
    reads = _site_reads(monkeypatch)
    ticks = 6
    _, timer = _traced(lambda: sim.run(StormSchedule(ticks=ticks, n=n)))
    gates = [v for site, v in reads if site != "prp_walk"]
    assert len(gates) == GATED_SITES * ticks
    assert timer.counters["gate.open"] == sum(gates) > 0
    # under loss the fanout's gate opens every tick
    assert sum(r[0] == "ping_req" for r in timer.log) == ticks


def test_walks_read_on_the_cpu_and_open_no_gate(monkeypatch):
    # n=400 lies in a Feistel domain of 4^5 = 1,024 (n / domain 0.39, as
    # 100k in 4^9): the walks are long for their size
    n = 400
    assert 4 ** prp.half_bits(n) == 1024
    sim = ScalableCluster(n, params=_lossy(n), replica_points=4, seed=3, device=CPU)
    reads = _site_reads(monkeypatch)
    ticks = 5
    _, timer = _traced(lambda: sim.run(StormSchedule(ticks=ticks, n=n)))
    walk = [v for site, v in reads if site == "prp_walk"]
    # two walks a tick, each ending in one read of False
    assert len(walk) - sum(walk) == 2 * ticks
    assert len(walk) > 4 * ticks
    # gate.open counts the gated phases alone, never a walk's reads
    gates = [v for site, v in reads if site != "prp_walk"]
    assert timer.counters["gate.open"] == sum(gates)


def test_trajectory_is_bitwise_with_the_log_on_and_off():
    n, ticks = 400, 30

    def run():
        sim = ScalableCluster(n, params=_lossy(n, loss=0.1), replica_points=4, seed=4,
                              device=CPU)
        return sim, sim.run(StormSchedule(ticks=ticks, n=n)), sim.ring_checksum()

    off, m_off, ring_off = run()
    (on, m_on, ring_on), timer = _traced(run)
    _assert_equal(off.state, on.state)
    _assert_equal(m_off, m_on)
    assert ring_on == ring_off
    assert int(m_on.refutes_published.sum()) > 0
    assert timer.counters["gate.open"] > 0


def test_mesh_counts_once_per_cluster_and_spans_each_shard():
    n, ticks = 400, 4
    p = _lossy(n, loss=0.2)
    solo = ScalableCluster(n, params=p, seed=5, device=CPU)
    m_solo, t_solo = _traced(lambda: solo.run(StormSchedule(ticks=ticks, n=n)))
    mesh = ShardedStorm(n, make_mesh(2, device=CPU), params=p, seed=5)
    m_mesh, t_mesh = _traced(lambda: mesh.run(StormSchedule(ticks=ticks, n=n)))
    _assert_equal(solo.state, mesh.state)
    # the float mean sums in the mesh's order (``sharded_mean_f32``)
    _assert_equal(m_solo._replace(mean_heard_frac=None), m_mesh._replace(mean_heard_frac=None))
    assert t_mesh.counters["gate.open"] == t_solo.counters["gate.open"] > 0
    shards = [r[4] for r in t_mesh.log if r[0] == "ping_req"]
    assert sorted(shards) == sorted([0, 1] * ticks)
    for r in t_mesh.log:
        if r[0] == "ping_req":
            assert t_mesh.log[r[3]][0] == "exchange" and t_mesh.log[r[3]][4] == r[4]


# ---------------------------------------------------------------------------
# the benchmark's driver and judge of the lossy cluster


def _driver(n, loss, chunk_ticks, warm_cycles=1, seed=2**31 + 11):
    from portbench.drivers.epidemic import Driver

    with open(os.path.join(REPO, "portbench", "configs", "ringpop-epidemic-100k.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "portbench", "traffic", "quiet.json")) as f:
        mix = json.load(f)
    config = dict(config, engine=dict(config["engine"], n=n, u=256, packet_loss=loss),
                  replica_points=4)
    mix = dict(mix, chunk_ticks=chunk_ticks, period=chunk_ticks)
    return Driver(dict(config=config["name"], traffic="quiet", warm_cycles=warm_cycles),
                  config, mix, seed, torch.device(CPU), False)


def _judged(driver, traced=False):
    """Set-up, one timed call and the judge, as ``run.py`` runs them; with
    ``traced`` the window's counters are read under the profiler."""
    driver.setup()
    driver.window_start()
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        c0 = driver.counters()
        driver.chunk()
        c1 = driver.counters()
    lines = []
    return {k: v for k, v, _ in driver.judge(lines.append)}, c0, c1, lines


def test_untraced_window_runs_with_no_span_log(monkeypatch):
    driver = _driver(512, 0.05, 10)
    driver.setup()
    logs = []
    tick = es.tick
    monkeypatch.setattr(es, "tick", lambda *a, **k: logs.append(perf.active()) or tick(*a, **k))
    assert set(driver.counters()) == {"host_read"}
    driver.chunk()
    assert set(driver.counters()) == {"host_read"}
    assert logs == [None] * 10


def test_epidemic_driver_and_judge_two_cycles_all_zero():
    numbers, c0, c1, lines = _judged(_driver(2048, 0.05, 60), traced=True)
    assert perf.active() is None
    assert set(numbers) == {"checksum_mismatch", "ring_mismatch", "plan_mismatch",
                            "start_mismatch", "window_mismatch", "loss_violations",
                            "refute_violations", "suspicion_violations"}
    assert all(v == 0 for v in numbers.values()), numbers
    # the window's counters: one cycle's gates and fanout time
    assert 0 < c1["gate.open"] - c0.get("gate.open", 0) <= GATED_SITES * 60
    assert c1["ping_req_ns"] > c0.get("ping_req_ns", 0)
    assert any("false suspects" in line for line in lines)


_PLANTED = {
    # the program runs as if the network lost nothing
    "loss_violations": lambda orig: lambda s, i, p, *a, **k: orig(
        s, i, p._replace(packet_loss=0.0), *a, **k),
    # a refute that keeps the defamed node's old incarnation
    "refute_violations": lambda orig: lambda s, i, p, *a, **k: _old_inc_refutes(
        s, *orig(s, i, p, *a, **k)),
    # every running suspicion clock set back by the timeout after the tick
    "suspicion_violations": lambda orig: lambda s, i, p, *a, **k: _clocks_set_back(
        p, *orig(s, i, p, *a, **k)),
}


def _old_inc_refutes(before, after, metrics):
    refuted = (before.truth_status > 0) & (before.truth_status < 3) & (after.truth_status == 0)
    return after._replace(
        truth_inc=torch.where(refuted, before.truth_inc, after.truth_inc)), metrics


def _clocks_set_back(params, after, metrics):
    since = after.susp_since
    return after._replace(susp_since=torch.where(
        since >= 0, since - params.suspicion_ticks, since)), metrics


@pytest.mark.parametrize("number", sorted(_PLANTED))
def test_planted_fault_raises_its_number(monkeypatch, number):
    monkeypatch.setattr(es, "tick", _PLANTED[number](es.tick))
    numbers, _, _, _ = _judged(_driver(1024, 0.2, 20))
    assert numbers[number] > 0, numbers
    if number == "loss_violations":
        assert numbers[number] == 20


# ---------------------------------------------------------------------------
# the port against the JAX engine


def test_quiet_lossy_cluster_bitwise_equal_to_jax_every_tick():
    n, ticks = 1000, 60
    kw = dict(n=n, u=256, suspicion_ticks=25, packet_loss=0.05, perm_impl="sortless",
              fused_exchange="xla")
    jp = jes.ScalableParams(**kw)
    pp = convert.scalable_params_from_jax_fields(jp._asdict())._replace(fused_exchange="plain")
    js = jes.init_state(jp, seed=3)
    ps = convert.scalable_state_from_numpy(
        {f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
         for f in jes.ScalableState._fields})
    step = jax.jit(lambda s, i: jes.tick(s, i, jp))
    quiet = jes.ChurnInputs(kill=jnp.zeros(n, bool), revive=jnp.zeros(n, bool))
    fired = dict(suspects_published=0, refutes_published=0)
    for t in range(ticks):
        js, jm = step(js, quiet)
        ps, pm = es.tick(ps, es.ChurnInputs.quiet(n), pp)
        got = convert.scalable_state_to_numpy(ps)
        for f in es.ScalableState._fields:
            want = getattr(js, f)
            if want is None:
                assert got[f] is None, (t, f)
            else:
                assert np.array_equal(got[f], np.asarray(want)), "tick %d: %s" % (t, f)
        for f in es.ScalableMetrics._fields:
            a, b = np.asarray(getattr(jm, f)), getattr(pm, f).numpy()
            if f == "mean_heard_frac":  # a float32 mean, bit for bit
                a, b = a.astype(np.float32).view(np.uint32), b.view(np.uint32)
            assert a.item() == b.item(), "tick %d: metric %s" % (t, f)
        for f in fired:
            fired[f] += int(getattr(pm, f))
    assert all(v > 0 for v in fired.values()), fired
