"""The port's fuzz package against the JAX package's: the scenario
generator, the batched executors, the invariant checker and the shrinker.

- ``scenarios.generate`` gives the JAX module's planes for 32 seeds of
  both engines (and the same sparse fault form, loss level and crash plan);
- the executors at tests/fuzz/test_executor.py's ``FULL_CFG`` and
  ``SCAL_CFG`` give the JAX executors' final states per instance,
  instance-major metrics and decoded event streams, and each instance
  equals the port's solo cluster;
- ``check_run`` gives the JAX checker's verdicts on the tier-1 smoke
  sweeps (tests/fuzz/test_fuzz_smoke.py) and on the seeded faults of
  tests/fuzz/test_mutation_gate.py that reach the port's engine internals,
  and the shrinker reduces a failing seed to the JAX shrinker's fixture;
- ``replay_fixture`` gives the JAX verdicts on the committed fixtures.

Everything runs on the CPU (the port's plain versions under vmap).
Tolerance: none — integer state, and the scalable ``mean_heard_frac`` in
the JAX CPU summation order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from ringpop_tpu.fuzz import executor as jfex
from ringpop_tpu.fuzz import invariants as jinv
from ringpop_tpu.fuzz import scenarios as jsc
from ringpop_tpu.fuzz import shrinker as jshrink
from ringpop_tpu.models.sim import flight as jflight
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.fuzz import executor as fex
from ringpop_tpu_torch.fuzz import invariants as inv
from ringpop_tpu_torch.fuzz import scenarios as sc
from ringpop_tpu_torch.fuzz import shrinker
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.cluster import SimCluster
from ringpop_tpu_torch.models.sim.storm import ScalableCluster
from ringpop_tpu_torch.ops import fused_apply as pfa

FULL_CFG = sc.ScenarioConfig(engine="full", n=8, ticks=12, loss_levels=(0.0,))
SCAL_CFG = sc.ScenarioConfig(engine="scalable", n=16, ticks=12, loss_levels=(0.0,))
FIXTURES = sorted((Path(__file__).parent / "fuzz" / "fixtures").glob("*.json"))
CPU = "cpu"


def _jcfg(cfg):
    return jsc.ScenarioConfig(**cfg._asdict())


def _planes(sched):
    return {k: None if v is None else np.asarray(v) for k, v in vars(sched).items()
            if isinstance(v, np.ndarray) or v is None}


@pytest.mark.parametrize("engine_name", ["full", "scalable"])
def test_generate_equals_jax(engine_name):
    cfg = sc.ScenarioConfig(engine=engine_name, n=24, ticks=30, max_moves=6)
    for seed in list(range(28)) + [2**31 - 1, 2**32 - 1, 123456789, 0xDEADBEEF]:
        got, want = sc.generate(seed, cfg), jsc.generate(seed, _jcfg(cfg))
        pg, pw = _planes(got), _planes(want)
        assert pg.keys() == pw.keys()
        for k in pg:
            assert (pg[k] is None and pw[k] is None) or np.array_equal(pg[k], pw[k]), (seed, k)
        faults = sc.sparse_faults(got, engine_name)
        assert faults == jsc.sparse_faults(want, engine_name)
        back = sc.schedule_from_faults(engine_name, cfg.n, cfg.ticks, faults, config=cfg)
        assert all(np.array_equal(a, b) for a, b in zip(_planes(back).values(), pg.values())
                   if a is not None)
        assert sc.packet_loss_of(seed, cfg) == jsc.packet_loss_of(seed, _jcfg(cfg))
        assert tuple(sc.crash_plan_of(seed, cfg)) == tuple(jsc.crash_plan_of(seed, _jcfg(cfg)))


def test_event_capacity_equals_jax():
    for n, ticks in ((8, 12), (8, 24), (16, 40), (64, 100)):
        assert fex.event_capacity_for(n, ticks) == jfex.event_capacity_for(n, ticks)
    cap = fex.event_capacity_for(8, 24)
    assert cap >= 25 * jflight.max_events_per_tick(8) and cap & (cap - 1) == 0


def _same_state_fields(got_state, want_state, to_numpy, what):
    got = to_numpy(got_state)
    for f, w in zip(type(want_state)._fields, want_state):
        if w is None:
            assert got[f] is None, (what, f)
        else:
            assert np.array_equal(got[f], np.asarray(w)), (what, f)


def _same_metrics(got, want, what):
    for f in type(want)._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.array_equal(g, w), (what, f)


@pytest.fixture(scope="module")
def full_runs():
    seeds = [0, 1, 2]
    ex = fex.FullFuzzExecutor(FULL_CFG, device=CPU)
    return ex, ex.run_seeds(seeds), jfex.FullFuzzExecutor(_jcfg(FULL_CFG)).run_seeds(seeds)


def test_full_executor_equals_jax(full_runs):
    ex, run, jrun = full_runs
    assert run.seeds == jrun.seeds and run.drops == jrun.drops == (0, 0, 0)
    _same_state_fields(run.final_state, jrun.final_state, convert.state_to_numpy, "full")
    _same_metrics(run.metrics, jrun.metrics, "full")
    assert run.metrics.pings_sent.shape == (3, FULL_CFG.ticks)
    assert run.events == jrun.events
    assert run.events[0] != run.events[1]


def test_full_instances_equal_solo_clusters(full_runs):
    ex, run, _ = full_runs
    for b, seed in enumerate(run.seeds):
        solo = SimCluster(n=FULL_CFG.n, params=ex.params, seed=seed, device=CPU)
        assert solo.params == ex.params  # no silent param drift
        solo.run(sc.generate(seed, FULL_CFG))
        for f in pe.SimState._fields:
            a, s = getattr(run.final_state, f), getattr(solo.state, f)
            assert (a is None and s is None) or torch.equal(a[b], s), (seed, f)


def test_scalable_executor_equals_jax_and_solo():
    seeds = [4, 9]
    scheds = [sc.generate(s, SCAL_CFG) for s in seeds]
    ex = fex.ScalableFuzzExecutor(SCAL_CFG, device=CPU)
    run = ex.run_schedules(scheds, seeds=seeds)
    jrun = jfex.ScalableFuzzExecutor(_jcfg(SCAL_CFG)).run_schedules(
        [jsc.generate(s, _jcfg(SCAL_CFG)) for s in seeds], seeds=seeds)
    _same_state_fields(run.final_state, jrun.final_state, convert.scalable_state_to_numpy,
                       "scalable")
    _same_metrics(run.metrics, jrun.metrics, "scalable")
    assert run.events is None and jrun.events is None
    for b, seed in enumerate(seeds):
        solo = ScalableCluster(n=SCAL_CFG.n, params=ex.params, seed=seed, device=CPU)
        solo.run(scheds[b])
        for f in pes.ScalableState._fields:
            a, s = getattr(run.final_state, f), getattr(solo.state, f)
            assert (a is None and s is None) or torch.equal(a[b], s), (seed, f)


def test_sweep_buckets_by_packet_loss():
    cfg = FULL_CFG._replace(loss_levels=(0.0, 0.25))
    seeds = list(range(12))
    runs = fex.sweep(seeds, cfg, device=CPU)
    assert {r.params.packet_loss for r in runs} == {sc.packet_loss_of(s, cfg) for s in seeds}
    assert sorted(s for r in runs for s in r.seeds) == seeds
    for r in runs:
        for s in r.seeds:
            assert sc.packet_loss_of(s, cfg) == r.params.packet_loss


def test_executor_rejects_recorderless_params():
    with pytest.raises(ValueError, match="flight_recorder"):
        fex.FullFuzzExecutor(
            FULL_CFG,
            params=fex.default_full_params(8, 12, device=CPU)._replace(flight_recorder=False),
            device=CPU,
        )


def _verdicts(by):
    return {b: sorted({v.invariant for v in vs}) for b, vs in by.items()}


def _verdicts_by_seed(runs, check, contract=None):
    out = {}
    for run in runs:
        for b, names in _verdicts(check(run, contract=contract)).items():
            out[run.seeds[b]] = names
    return out


@pytest.mark.parametrize("engine_name,n,ticks", [("full", 8, 20), ("scalable", 32, 24)])
def test_smoke_sweep_verdicts_equal_jax(engine_name, n, ticks):
    cfg = sc.ScenarioConfig(engine=engine_name, n=n, ticks=ticks, loss_levels=(0.0, 0.1))
    runs = fex.sweep(list(range(8)), cfg, device=CPU)
    jruns = jfex.sweep(list(range(8)), _jcfg(cfg))
    assert [r.seeds for r in runs] == [r.seeds for r in jruns]
    got = _verdicts_by_seed(runs, inv.check_run)
    assert got == _verdicts_by_seed(jruns, jinv.check_run) == {}
    for r, jr in zip(runs, jruns):
        _same_metrics(r.metrics, jr.metrics, (engine_name, r.seeds))
        assert r.events == jr.events and r.drops == jr.drops


MUT_FULL = sc.ScenarioConfig(engine="full", n=8, ticks=24, loss_levels=(0.05,))
MUT_SCAL = sc.ScenarioConfig(engine="scalable", n=16, ticks=20, loss_levels=(0.05,))


def test_shortened_suspicion_caught_and_shrunk_as_jax(tmp_path):
    """The engine expires suspicions after 2 ticks against a contract of 6:
    both checkers name suspicion-lower-bound on the same instances, and
    the port's shrinker reduces seed 0 to the committed fixture the JAX
    shrinker made from the same mutation, which the healthy engine
    replays clean."""
    contract = fex.default_full_params(8, 24, 0.05, device=CPU)
    ex = fex.FullFuzzExecutor(MUT_FULL, params=contract._replace(suspicion_ticks=2),
                              shared_cache=False, device=CPU)
    jcontract = jfex.default_full_params(8, 24, 0.05)
    jex = jfex.FullFuzzExecutor(_jcfg(MUT_FULL), params=jcontract._replace(suspicion_ticks=2),
                                shared_cache=False)
    seeds = list(range(8))
    by = inv.check_run(ex.run_seeds(seeds), contract=contract)
    assert _verdicts(by) == _verdicts(jinv.check_run(jex.run_seeds(seeds), contract=jcontract))
    assert "suspicion-lower-bound" in {v.invariant for v in by[0]}
    res = shrinker.shrink_seed(ex, 0, contract=contract)
    committed = shrinker.load_fixture(str(FIXTURES[0]))
    assert committed["seed"] == 0 and committed["packet_loss"] == 0.05
    assert [list(f) for f in res.faults] == committed["faults"]
    assert res.invariant_names == committed["invariants"]
    path = tmp_path / "m.json"
    shrinker.save_fixture(res, str(path), note=committed["note"])
    doc = shrinker.load_fixture(str(path))
    assert doc == committed
    assert shrinker.replay_fixture(doc, contract=contract, device=CPU) == []


def test_suppressed_refute_path_is_caught(monkeypatch):
    """A node that believes its own defamation instead of refuting trips
    self-view-alive (the classic tick's ``_apply_updates`` mutated, as the
    JAX gate mutates its own)."""
    orig = pe._apply_updates

    def no_refute(state, now, recv_mask, u_status, u_inc, u_source, u_source_inc):
        n = state.known.shape[0]
        ids = torch.arange(n, dtype=torch.int32)
        is_self = ids[:, None] == ids[None, :]
        self_defame = recv_mask & is_self & ((u_status == 1) | (u_status == 2))
        st, gate, start_t, stop_t, refute = orig(
            state, now, recv_mask & ~self_defame, u_status, u_inc, u_source, u_source_inc)
        st = st._replace(status=torch.where(self_defame, u_status, st.status),
                         inc=torch.where(self_defame, u_inc, st.inc))
        return st, gate | self_defame, start_t, stop_t, refute & False

    monkeypatch.setattr(pe, "_apply_updates", no_refute)
    params = fex.default_full_params(8, 24, 0.05, device=CPU)._replace(fused_tick="off")
    ex = fex.FullFuzzExecutor(MUT_FULL, params=params, shared_cache=False, device=CPU)
    names = {v.invariant for vs in inv.check_run(ex.run_seeds(list(range(6)))).values()
             for v in vs}
    assert "self-view-alive" in names


def test_stale_alive_override_is_caught(monkeypatch):
    """SWIM precedence broken so a stale ALIVE at an equal incarnation
    overrides FAULTY: alive-after-faulty-refute (the JAX gate's slow-tier
    mutation; the port's fused sites read ``overrides`` at call time)."""
    orig = pfa.overrides

    def broken(u_status, u_inc, c_status, c_inc):
        return orig(u_status, u_inc, c_status, c_inc) | (
            (u_status == 0) & (c_status == 2) & (u_inc >= c_inc))

    monkeypatch.setattr(pfa, "overrides", broken)
    cfg = sc.ScenarioConfig(engine="full", n=8, ticks=32, loss_levels=(0.2,))
    ex = fex.FullFuzzExecutor(cfg, packet_loss=0.2, shared_cache=False, device=CPU)
    names = {v.invariant for vs in inv.check_run(ex.run_seeds(list(range(48)))).values()
             for v in vs}
    assert "alive-after-faulty-refute" in names


def test_scalable_dropped_publish_delta_caught_and_shrunk(monkeypatch):
    """An incremental checksum that forgets the publish delta diverges from
    the full recompute: scalable-checksum-exact, shrunk to <= 2 faults."""
    orig = pes._publish_batch

    def no_delta(state, csum, slot, subj, new_status, new_inc, hearer, tick):
        st, _ = orig(state, csum, slot, subj, new_status, new_inc, hearer, tick)
        return st, csum

    monkeypatch.setattr(pes, "_publish_batch", no_delta)
    ex = fex.ScalableFuzzExecutor(MUT_SCAL, packet_loss=0.05, shared_cache=False, device=CPU)
    run = ex.run_seeds(list(range(6)))
    by = inv.check_run(run)
    assert "scalable-checksum-exact" in {v.invariant for vs in by.values() for v in vs}
    res = shrinker.shrink_seed(ex, run.seeds[sorted(by)[0]], target=["scalable-checksum-exact"])
    assert res.invariant_names == ["scalable-checksum-exact"] and len(res.faults) <= 2


def test_scalable_shortened_suspicion_verdicts_equal_jax():
    contract = fex.default_scalable_params(16, 0.05)
    ex = fex.ScalableFuzzExecutor(MUT_SCAL, params=contract._replace(suspicion_ticks=2),
                                  shared_cache=False, device=CPU)
    jcontract = jfex.default_scalable_params(16, 0.05)
    jex = jfex.ScalableFuzzExecutor(_jcfg(MUT_SCAL), params=jcontract._replace(suspicion_ticks=2),
                                    shared_cache=False)
    seeds = list(range(8))
    by = inv.check_run(ex.run_seeds(seeds), contract=contract)
    assert _verdicts(by) == _verdicts(jinv.check_run(jex.run_seeds(seeds), contract=jcontract))
    assert "suspicion-lower-bound" in {v.invariant for vs in by.values() for v in vs}


def test_shrink_refuses_a_passing_schedule():
    ex = fex.FullFuzzExecutor(MUT_FULL, packet_loss=0.05, device=CPU)
    with pytest.raises(ValueError, match="does not violate"):
        shrinker.shrink(ex, [("kill", 3, 1, 1)], seed=0)


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_replay_fixture_verdicts_equal_jax(path):
    doc = shrinker.load_fixture(str(path))
    assert doc == jshrink.load_fixture(str(path))
    got = shrinker.replay_fixture(doc, device=CPU)
    assert got == jshrink.replay_fixture(doc) == []
