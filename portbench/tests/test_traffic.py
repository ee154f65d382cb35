"""The one churn generator: deterministic from the seed, and keeping the
mixes' stated parameters."""

import json
import os

import numpy as np
import pytest

from portbench.lib.traffic import ChurnPlan

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mix(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def plans(m, n, seed, chunks):
    p = ChurnPlan(m, n, seed)
    return [p.chunk(c) for c in range(chunks)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3, 2**40 + 1])
def test_same_seed_same_plan_other_seed_other_victims(seed):
    m = mix("churn-b32")
    a, b = plans(m, 1024, seed, 4), plans(m, 1024, seed, 4)
    for (ka, ra), (kb, rb) in zip(a, b):
        assert (ka == kb).all() and (ra == rb).all()
    other = plans(m, 1024, seed + 1, 4)
    assert any((ka != ko).any() for (ka, _), (ko, _) in zip(a, other))
    # ...with the same sizes and arrivals
    for (ka, ra), (ko, ro) in zip(a, other):
        assert (ka.sum(1) == ko.sum(1)).all() and (ra.sum(1) == ro.sum(1)).all()


def test_pulse_keeps_period_kills_and_revive_lag():
    m = mix("churn-b32")
    n = 1024
    chunks = plans(m, n, 99, 6)
    kill = np.concatenate([k for k, _ in chunks])
    revive = np.concatenate([r for _, r in chunks])
    ticks = np.flatnonzero(kill.any(1))
    assert (ticks == np.arange(5, kill.shape[0], 10)).all()
    assert (kill[ticks].sum(1) == n // 200).all()
    for t in ticks:
        if t + 40 < kill.shape[0]:
            assert (revive[t + 40] == kill[t]).all()
    assert not revive[:45].any()
    # a live draw never kills a node that is down, or comes back that tick
    down = np.zeros(n, bool)
    for t in range(kill.shape[0]):
        assert not (kill[t] & down).any()
        down = (down & ~revive[t]) | kill[t]
        assert down.sum() <= 4 * (n // 200)
    assert down.sum() == 4 * (n // 200)


@pytest.mark.parametrize("name,n", [("churn-b32", 1024), ("churn", 20_000)])
def test_fill_into_reused_arrays_equals_a_fresh_chunk(name, n):
    """What the drivers time: victims drawn ahead (``prepare``), each chunk
    written over the last one's arrays (``fill``)."""
    m = mix(name)
    fresh = plans(m, n, 2**35 + 1, 7)
    p = ChurnPlan(m, n, 2**35 + 1)
    p.prepare(0, 7)
    kill = np.zeros((p.chunk_ticks, n), bool)
    revive = np.zeros_like(kill)
    for c, (k, r) in enumerate(fresh):
        p.fill(c, kill, revive)
        assert (kill == k).all() and (revive == r).all()


def test_down_after_follows_the_plan():
    m = mix("churn-b32")
    n = 1024
    p = ChurnPlan(m, n, 5)
    down = np.zeros(n, bool)
    for c in range(5):
        kill, revive = p.chunk(c)
        for t in range(kill.shape[0]):
            down = (down & ~revive[t]) | kill[t]
        assert (ChurnPlan(m, n, 5).down_after(c) == down).all()


def test_storm_cycle_keeps_fraction_and_ticks():
    n = 20_000  # the generator's arithmetic at a smaller n
    chunks = plans(mix("churn"), n, 2**33, 3)
    for c, (kill, revive) in enumerate(chunks):
        assert kill.shape == (60, n)
        assert np.flatnonzero(kill.any(1)).tolist() == [2]
        assert np.flatnonzero(revive.any(1)).tolist() == [30]
        assert kill[2].sum() == n // 10 and (revive[30] == kill[2]).all()
    assert (chunks[0][0][2] != chunks[1][0][2]).any()


def test_storm_victims_come_from_seed_and_cycle():
    m = mix("churn")
    a = ChurnPlan(m, 5000, 3).victims(4)
    b = ChurnPlan(m, 5000, 3).victims(4)
    assert (a == b).all()
    rng = np.random.default_rng([3, 4])
    assert (np.sort(rng.choice(5000, 500, replace=False)) == a).all()


def test_mix_without_a_parameter_is_refused():
    m = dict(mix("churn"))
    del m["revive_after"]
    with pytest.raises(ValueError, match="revive_after"):
        ChurnPlan(m, 100, 0)
