"""The port's ScalableCluster against the JAX one, on the schedules of
tests/models/test_storm.py, and the scalable engine's FarmHash truth
checksum against the host string hash.

The two clusters start from the same seed (``init_state`` draws the same
numpy randomness) and run the same ``StormSchedule``; every per-tick
metric (``mean_heard_frac``, a float32 mean, bit for bit too), the final
state, the checksums and the ring digest must be equal, and the port must
reach the outcomes those
JAX tests assert.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import ScalableCluster as JaxCluster
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _clusters(n, seed=0, **kw):
    jc = JaxCluster(n=n, params=jes.ScalableParams(n=n, **kw), seed=seed)
    pc = ScalableCluster(n=n, params=pes.ScalableParams(n=n, **kw), seed=seed, device="cpu")
    return jc, pc


def _schedules(ticks, n, **planes):
    return JaxSchedule(ticks=ticks, n=n, **planes), StormSchedule(ticks=ticks, n=n, **planes)


def _assert_same_run(jm, pm, jc, pc):
    for f in pes.ScalableMetrics._fields:
        a, b = np.asarray(getattr(jm, f)), getattr(pm, f)
        assert b.shape == a.shape and np.array_equal(b, a), f
    got = convert.scalable_state_to_numpy(pc.state)
    for f in pes.ScalableState._fields:
        want = getattr(jc.state, f)
        assert (want is None and got[f] is None) or np.array_equal(got[f], np.asarray(want)), f
    assert np.array_equal(pc.checksums(), np.asarray(jc.checksums()))
    assert pc.ring_checksum() == jc.ring_checksum()


def test_churn_storm_reconverges_like_jax():
    n = 64
    jc, pc = _clusters(n, u=192, suspicion_ticks=4)
    ring0 = pc.ring_checksum()
    assert ring0 == jc.ring_checksum()
    kw = dict(ticks=40, n=n, fraction=0.1, fail_tick=1, rejoin_tick=20, seed=3)
    jm = jc.run(JaxSchedule.churn_storm(**kw))
    pm = pc.run(StormSchedule.churn_storm(**kw))
    _assert_same_run(jm, pm, jc, pc)
    assert pm.suspects_published.sum() >= 1 and pm.faulties_published.sum() >= 1
    assert int(pm.distinct_checksums[-1]) == 1 and int(pm.live_nodes[-1]) == n
    assert pc.ring_checksum() == ring0


def test_ring_checksum_tracks_membership_like_jax():
    n = 32
    jc, pc = _clusters(n, u=192, suspicion_ticks=2)
    r_full = pc.ring_checksum()
    js, ps = _schedules(10, n)
    js.kill[1, :4] = True
    ps.kill[1, :4] = True
    _assert_same_run(jc.run(js), pc.run(ps), jc, pc)
    assert int(pc.state.truth_status[:4].max()) >= pes.SUSPECT
    assert pc.ring_checksum() != r_full


def test_checksum_on_demand_mode_like_jax():
    n = 32
    jc, pc = _clusters(n, u=192, checksum_in_tick=False)
    js, ps = _schedules(5, n)
    _assert_same_run(jc.run(js), pc.run(ps), jc, pc)
    assert np.unique(pc.checksums()).size == 1


def test_storm_schedule_with_leaves_like_jax():
    n = 48
    jc, pc = _clusters(n, seed=3, u=256, suspicion_ticks=4, enable_leave=True)
    leave = np.zeros((50, n), bool)
    kill = np.zeros((50, n), bool)
    revive = np.zeros((50, n), bool)
    leave[2, :6] = True
    kill[2, 10:13] = True
    revive[25, :6] = True
    revive[25, 10:13] = True
    js, ps = _schedules(50, n, kill=kill, revive=revive, leave=leave)
    pm = pc.run(ps)
    _assert_same_run(jc.run(js), pm, jc, pc)
    assert int(pm.leaves_published[2]) == 6
    assert int(pm.live_nodes[-1]) == n and int(pm.distinct_checksums[-1]) == 1
    assert (pc.state.truth_status == pes.ALIVE).all()


def test_step_equals_run_and_resolution():
    n = 32
    params = pes.ScalableParams(n=n, u=192, suspicion_ticks=2, packet_loss=0.1)
    a = ScalableCluster(n=n, params=params, seed=5, device="cpu")
    b = ScalableCluster(n=n, params=params, seed=5, device="cpu")
    sched = StormSchedule.churn_storm(12, n, 0.2, fail_tick=1, rejoin_tick=6, seed=1)
    ms = a.run(sched)
    for t in range(sched.ticks):
        m = b.step(pes.ChurnInputs(kill=torch.as_tensor(sched.kill[t]),
                                   revive=torch.as_tensor(sched.revive[t])))
        for f in pes.ScalableMetrics._fields:
            assert np.array_equal(getattr(m, f), getattr(ms, f)[t]), (t, f)
    for f in pes.ScalableState._fields:
        x, y = getattr(a.state, f), getattr(b.state, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    res = a.exchange_resolution()
    assert (res["requested"], res["impl"], res["mode"]) == ("auto", "plain", "inline")
    assert set(res) == set(JaxCluster(n=n, params=jes.ScalableParams(n=n, u=192))
                           .exchange_resolution())


def test_cluster_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScalableCluster(n=8, params=pes.ScalableParams(n=8, u=128))


def test_farmhash_truth_checksum_matches_host_and_jax():
    from ringpop_tpu.models.sim.cluster import default_addresses
    from ringpop_tpu.ops import checksum_encode as jce
    from ringpop_tpu_torch.ops import checksum_encode as pce
    from ringpop_tpu_torch.ops import farmhash32, u32

    n = 64
    addrs = default_addresses(n)
    juni, puni = jce.Universe.from_addresses(addrs), pce.Universe.from_addresses(addrs)
    jc, pc = _clusters(n, u=128, suspicion_ticks=3)

    def host_truth():
        status = pc.state.truth_status.numpy()
        inc = pc.state.truth_inc.numpy()
        members = sorted(
            (a, pce.STATUS_STRINGS[int(status[j])],
             pc.params.epoch + (int(inc[j]) - 1) * 200 if inc[j] > 0 else 0)
            for j, a in enumerate(puni.addresses)
        )
        return farmhash32.hash32(";".join("%s%s%d" % m for m in members))

    def check():
        got = int(u32.to_numpy(pes.farmhash_truth_checksum(pc.state, puni, pc.params)))
        assert got == host_truth()
        assert got == int(jes.farmhash_truth_checksum(jc.state, juni, jc.params, impl="xla"))

    check()
    js, ps = _schedules(11, n)
    js.kill[0, 7] = True
    ps.kill[0, 7] = True
    _assert_same_run(jc.run(js), pc.run(ps), jc, pc)
    assert {0, 2} <= set(np.unique(pc.state.truth_status.numpy()).tolist())
    check()
