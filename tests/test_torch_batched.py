"""The port's batch axis: ``BatchedSimClusters`` against the JAX module's,
each cluster against the port's solo cluster, and the batched full and
scalable ticks under ``torch.func.vmap`` with no functorch fallback.

The JAX module vmaps its tick with ``in_axes=(0, None)``; the port runs
``torch.func.vmap`` over the state's tensor fields with the kernel
wrappers' batching rules (their plain versions here, on the CPU).  The
b=3, n=48, 28-tick run with a kill and a revive is the one of
tests/models/test_batched.py.  Tolerance: none — every field is integer
(and the scalable ``mean_heard_frac`` is summed in the JAX CPU order), so
every comparison is bitwise.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.models.sim.batched import BatchedSimClusters as JaxBatched
from ringpop_tpu.models.sim.cluster import EventSchedule as JaxSchedule
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import batched as pb
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.batched import BatchedSimClusters
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.obs import events as pev
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

B, N, T, SEED = 3, 48, 28, 11


def _schedules(n, ticks, kill=((5, 7),), revive=((18, 7),)):
    js, ps = JaxSchedule(ticks=ticks, n=n), EventSchedule(ticks=ticks, n=n)
    for t, v in kill:
        js.kill[t, v] = ps.kill[t, v] = True
    for t, v in revive:
        js.revive[t, v] = ps.revive[t, v] = True
    return js, ps


def _same_metrics(got, want, what):
    for f in pe.TickMetrics._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.array_equal(g, w), (what, f)


def _same_state(port_state, jax_state, what):
    got = convert.state_to_numpy(port_state)
    for f in je.SimState._fields:
        w = getattr(jax_state, f)
        if w is None:
            assert got[f] is None, (what, f)
            continue
        assert np.array_equal(got[f], np.asarray(w)), (what, f)


@pytest.fixture(scope="module")
def headline_pair():
    """The port's and the JAX module's batched runs of one schedule."""
    js, ps = _schedules(N, T)
    jb = JaxBatched(b=B, n=N, seed=SEED)
    jboot = jb.bootstrap()
    jms = jb.run(js)
    bat = BatchedSimClusters(b=B, n=N, seed=SEED, device="cpu")
    pboot = bat.bootstrap()
    pms = bat.run(ps)
    return jb, jboot, jms, bat, pboot, pms, ps


def test_batched_equals_jax_bitwise(headline_pair):
    jb, jboot, jms, bat, pboot, pms, _ = headline_pair
    _same_metrics(pboot, jboot, "bootstrap")
    _same_metrics(pms, jms, "run")
    assert pms.converged.shape == (T, B)
    assert np.array_equal(bat.checksums(), np.asarray(jb.checksums()))
    _same_state(bat.state, jb.state, "final")
    assert bool(pms.converged[-1].all())


def test_each_cluster_equals_its_solo_cluster(headline_pair):
    _, _, _, bat, pboot, pms, ps = headline_pair
    for i in range(B):
        solo = SimCluster(
            n=N, params=pe.SimParams(n=N, checksum_mode="fast", gate_phases=False),
            seed=SEED + i, device="cpu",
        )
        m0 = solo.bootstrap()
        m1 = solo.run(ps)
        for f in pe.TickMetrics._fields:
            assert np.array_equal(getattr(pboot, f)[i], getattr(m0, f)), (i, f)
            assert np.array_equal(getattr(pms, f)[:, i], getattr(m1, f)), (i, f)
        for f in pe.SimState._fields:
            a, b = getattr(bat.state, f), getattr(solo.state, f)
            assert (a is None and b is None) or torch.equal(a[i], b), (i, f)


def test_clusters_are_independent():
    """Different seeds give different mid-bootstrap trajectories: no state
    bleeds across the batch axis."""
    bat = BatchedSimClusters(b=2, n=N, seed=3, device="cpu")
    bat.bootstrap()
    ms = bat.run(EventSchedule(ticks=6, n=N))
    assert (ms.changes_applied[:, 0] != ms.changes_applied[:, 1]).any()


@pytest.mark.parametrize("extra", [
    {"fused_checksum": "on"}, {"fused_tick": "off", "fused_checksum": "off"},
], ids=["fused", "classic"])
def test_farmhash_batched_equals_jax(extra):
    """Farmhash mode at n=16: the fused record-cache pipeline (pinned to
    its "full" shape under the batch axis), and the classic configuration
    (the classic tick, the unfused recompute through the block loop)."""
    n, ticks = 16, 14
    js, ps = _schedules(n, ticks, kill=((3, 2),), revive=((8, 2),))
    jp = je.SimParams(n=n, checksum_mode="farmhash", suspicion_ticks=4, **extra)
    pp = pe.SimParams(n=n, checksum_mode="farmhash", suspicion_ticks=4, **extra)
    jb = JaxBatched(b=2, n=n, params=jp, seed=21)
    bat = BatchedSimClusters(b=2, n=n, params=pp, seed=21, device="cpu")
    assert bat.params.parity_recompute == "full" and not bat.params.gate_phases
    _same_metrics(bat.bootstrap(), jb.bootstrap(), "bootstrap")
    _same_metrics(bat.run(ps), jb.run(js), "run")
    _same_state(bat.state, jb.state, "final")


def test_flight_recorder_drains_per_cluster():
    """The batched flight recorder: per-cluster streams equal to the JAX
    module's drains, each reconciling with its cluster's metric column;
    the drain resets every cluster's head."""
    b, n, ticks = 2, 8, 6
    kw = dict(n=n, checksum_mode="fast", flight_recorder=True, event_capacity=4096)
    jb = JaxBatched(b=b, n=n, params=je.SimParams(**kw), seed=5)
    bat = BatchedSimClusters(b=b, n=n, params=pe.SimParams(**kw), seed=5, device="cpu")
    for x in (jb, bat):
        x.bootstrap()
    assert bat.drain_events() == jb.drain_events()
    ms = bat.run(EventSchedule(ticks=ticks, n=n))
    jb.run(JaxSchedule(ticks=ticks, n=n))
    streams = bat.drain_events(reset=False)
    assert streams == jb.drain_events(reset=False)
    assert len(streams) == b and streams[0] != streams[1]
    for i, stream in enumerate(streams):
        per_cluster = {f: getattr(ms, f)[:, i] for f in pe.TickMetrics._fields}
        rec = pev.reconcile(stream, per_cluster)
        assert rec and all(v["match"] for v in rec.values()), (i, rec)
    bat.drain_events()
    assert (bat.state.ev_head == 0).all() and (bat.state.ev_drops == 0).all()


def test_batched_run_log(tmp_path):
    """``attach_recorder``: the batched metrics ([B] vectors a row) and the
    per-cluster drain counts land in a run log the JAX validator accepts."""
    from ringpop_tpu.obs.recorder import validate_run_log
    from ringpop_tpu_torch.obs.recorder import RunRecorder

    n = 8
    bat = BatchedSimClusters(b=2, n=n, params=pe.SimParams(
        n=n, checksum_mode="fast", flight_recorder=True, event_capacity=4096), seed=5,
        device="cpu")
    rec = RunRecorder(str(tmp_path / "batched.runlog.jsonl"))
    bat.attach_recorder(rec)
    bat.bootstrap()
    bat.run(EventSchedule(ticks=4, n=n))
    streams = bat.drain_events()
    rec.finish()
    assert validate_run_log(rec.path) == []
    rows = [json.loads(line) for line in open(rec.path)]
    drain = [r for r in rows if r.get("name") == "flight_drain"]
    assert drain and drain[0]["events"] == [len(x) for x in streams]
    assert rows[0]["config"]["engine"] == "sim.engine[batched]" and rows[0]["config"]["b"] == 2


@pytest.fixture
def no_fallback():
    """Turn functorch's fallback warning (an op with no batching rule run
    one instance at a time) into an error for the test's duration."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            warnings.filterwarnings("error", message=".*fallback.*")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.mark.parametrize("mode", ["fast", "farmhash", "classic"])
def test_batched_full_tick_has_no_fallback(no_fallback, mode):
    n = 16
    kw = dict(checksum_mode="fast" if mode == "fast" else "farmhash", flight_recorder=True,
              histograms=True, event_capacity=8192, packet_loss=0.1)
    if mode == "classic":
        kw.update(fused_tick="off", fused_checksum="off")
    bat = BatchedSimClusters(b=2, n=n, params=pe.SimParams(n=n, **kw), seed=1, device="cpu")
    bat.bootstrap()
    _, ps = _schedules(n, 8, kill=((2, 3),), revive=((5, 3),))
    ms = bat.run(ps)
    assert ms.pings_sent.shape == (8, 2)


def _scalable_schedule(n, ticks):
    from ringpop_tpu_torch.models.sim.storm import StormSchedule

    s = StormSchedule(ticks=ticks, n=n)
    s.kill[1, [2, 9]] = True
    s.revive[6, 2] = True
    s.leave = np.zeros((ticks, n), bool)
    s.leave[3, 5] = True
    return s


@pytest.mark.parametrize("fused_exchange", ["off", "plain", "kernel"])
def test_batched_scalable_tick_equals_solo_without_fallback(no_fallback, fused_exchange):
    """The scalable tick under vmap (the batched PRP walk, the out-of-place
    delta sum; "kernel" goes through the exchange wrapper's batching rule,
    its plain version on the CPU): each instance equals its solo run on
    every field of every tick."""
    n, ticks = 33, 10  # n = 33: a ragged Feistel domain, so walks take steps
    params = pes.ScalableParams(n=n, u=256, suspicion_ticks=3, packet_loss=0.1,
                                enable_leave=True, gate_phases=False, perm_impl="sortless",
                                fused_exchange=fused_exchange, histograms=True, wavefront=True,
                                exchange_metrics=3)
    seeds = (4, 9)
    solos = [pes.init_state(params, seed=s, device="cpu") for s in seeds]
    state = pb.stack_states(solos)
    inputs = _scalable_schedule(n, ticks).as_inputs("cpu")
    step = lambda s, i: pes.tick(s, i, params)
    for t in range(ticks):
        row = type(inputs)(*(None if x is None else x[t] for x in inputs))
        state, m = pb.vmap_tick(step, state, row)
        for i in range(len(seeds)):
            solos[i], mi = step(solos[i], row)
            for f in pes.ScalableState._fields:
                a, b = getattr(state, f), getattr(solos[i], f)
                assert (a is None and b is None) or torch.equal(a[i], b), (t, i, f)
            for f in pes.ScalableMetrics._fields:
                assert torch.equal(getattr(m, f)[i], getattr(mi, f)), (t, i, f)


def test_obs_field_registries_equal_jax_and_cover_every_field():
    """The trajectory / obs-only field registries (``fuzz.executor.
    split_obs`` drains by them) equal the JAX engines' and split every
    state field of the port in two."""
    from ringpop_tpu.models.sim import engine_scalable as jes
    from ringpop_tpu_torch.fuzz.executor import split_obs

    for obs, traj, jobs, jtraj, cls in (
        (pe.SIM_OBS_ONLY_FIELDS, pe.SIM_TRAJECTORY_FIELDS, je.SIM_OBS_ONLY_FIELDS,
         je.SIM_TRAJECTORY_FIELDS, pe.SimState),
        (pes.SCALABLE_OBS_ONLY_FIELDS, pes.SCALABLE_TRAJECTORY_FIELDS,
         jes.SCALABLE_OBS_ONLY_FIELDS, jes.SCALABLE_TRAJECTORY_FIELDS, pes.ScalableState),
    ):
        assert obs == jobs and traj == jtraj
        assert not obs & traj and obs | traj == set(cls._fields)
    params = pe.SimParams(n=8, checksum_mode="fast", flight_recorder=True, histograms=True)
    st = pe.init_state(params, seed=0)
    traj, planes = split_obs(st)
    assert set(planes) == pe.SIM_OBS_ONLY_FIELDS
    assert all(getattr(traj, f) is None for f in pe.SIM_OBS_ONLY_FIELDS)
    assert traj.known is st.known
