"""The reference's own code, held to published and Node-validated values.

``PARITY_TRAJECTORY.json`` and ``PARITY_REPLAY.json`` (the repo's root)
hold views with the checksum ringpop-node computed for them
(``scripts/replay_node.md``); they are read here as JSON.  The record hash
and the ring digest are held to the program's own, which the benchmark
then guards: two codes written apart that agree.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from portbench.reference import checksum as cs
from portbench.reference import farmhash, mix
from portbench.reference import storm as ref_storm
from portbench.tests.conftest import REPO


def _json(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _node_string(members):
    return ";".join("%s%s%d" % m for m in sorted(members))


def test_published_empty_string_hash():
    assert farmhash.hash32(b"") == 0xDC56D17A


def test_node_checksums_of_the_parity_replay():
    snaps = _json("PARITY_REPLAY.json")["snapshots"]
    assert snaps
    for s in snaps:
        members = [(m["address"], m["status"], m["incarnationNumber"]) for m in s["members"]]
        assert farmhash.hash32(_node_string(members)) == s["expected_checksum"]


def test_node_checksums_of_the_parity_trajectory_row_by_row():
    """Every view the trajectory spells out, through the batched builder
    and hash the ensemble's check uses, and through the scalar hash."""
    d = _json("PARITY_TRAJECTORY.json")
    addrs = cs.addresses(d["n"])
    at = {a: i for i, a in enumerate(addrs)}
    code = {s: i for i, s in enumerate(cs.STATUS_STRINGS)}
    known, status, inc, want = [], [], [], []
    for tick in d["ticks_data"]:
        for g in tick["groups"]:
            if "representative" not in g:
                continue
            members = g["representative"]["members"]
            k = torch.zeros(d["n"], dtype=torch.bool)
            st = torch.zeros(d["n"], dtype=torch.int64)
            ms = torch.zeros(d["n"], dtype=torch.int64)
            for a, s, i in members:
                k[at[a]], st[at[a]], ms[at[a]] = True, code[s], i
            known.append(k), status.append(st), inc.append(ms), want.append(g["checksum"])
            if len(want) <= 4:
                assert farmhash.hash32(_node_string([tuple(m) for m in members])) == g["checksum"]
    assert len(want) >= 40
    got = cs.view_checksums(addrs, torch.stack(known), torch.stack(status), torch.stack(inc))
    assert got.tolist() == want


def test_batched_hash_equals_the_scalar_one_at_every_length():
    rng = random.Random(3)
    strings = [bytes(rng.randrange(32, 127) for _ in range(n))
               for n in list(range(25, 90)) + [199, 200, 201, 1000, 4097]]
    width = (max(map(len, strings)) + 3) // 4 * 4
    rows = torch.zeros((len(strings), width), dtype=torch.uint8)
    for r, s in enumerate(strings):
        rows[r, :len(s)] = torch.tensor(list(s), dtype=torch.uint8)
    got = farmhash.hash32_rows(rows, torch.tensor([len(s) for s in strings]))
    assert got.tolist() == [farmhash.hash32(s) for s in strings]


def test_scalar_hash_agrees_with_the_program_at_every_short_length():
    from ringpop_tpu_torch.ops import farmhash32

    rng = random.Random(5)
    for n in range(0, 64):
        s = "".join(chr(rng.randrange(32, 127)) for _ in range(n))
        assert farmhash.hash32(s) == farmhash32.hash32(s), n


def test_record_hash_and_ring_digest_agree_with_the_program():
    from ringpop_tpu_torch.models.ring import device as ring
    from ringpop_tpu_torch.ops import u32
    from ringpop_tpu_torch.ops.record_mix import record_mix

    g = torch.Generator().manual_seed(1)
    s = torch.randint(0, 2**31 - 1, (4096,), generator=g, dtype=torch.int32)
    t = torch.randint(0, 4, (4096,), generator=g, dtype=torch.int32)
    c = torch.randint(0, 2**31 - 1, (4096,), generator=g, dtype=torch.int32)
    want = record_mix(s, t, c).to(torch.int64) & mix.M32
    assert (mix.record_mix(s, t, c) == want).all()
    for n, points in ((300, 100), (1000, 16)):
        in_ring = torch.rand(n, generator=g) < 0.9
        table = ring.build_ring(ring.device_replica_hashes(n, points), in_ring)
        assert mix.ring_digest(in_ring, points, block=1000) == int(
            u32.to_numpy(ring.ring_checksum(table)))


@pytest.mark.parametrize("seed", [4, 2**33 + 1])
def test_storm_checksums_recomputed_from_the_state(seed):
    """After churn, every node's checksum is base_sum plus the deltas it
    heard, and the deltas sum to the truth's checksum."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule

    sim = ScalableCluster(512, params=es.ScalableParams(n=512, u=192), seed=seed, device="cpu")
    sim.run(StormSchedule.churn_storm(30, 512, fraction=0.1, fail_tick=2, rejoin_tick=20,
                                      seed=seed))
    st = sim.state
    assert int((st.truth_inc > 1).sum()) > 0
    assert (ref_storm.heard_sums(st) == (es.compute_checksums(st, sim.params).to(torch.int64)
                                         & mix.M32)).all()
    assert ref_storm.checksum_mismatch(st) == 0
    broken = st._replace(truth_inc=st.truth_inc + (torch.arange(512) == 7).int())
    assert ref_storm.checksum_mismatch(broken) == 1


def test_view_checksum_rejects_what_the_node_string_does_not_hold():
    n = 64
    addrs = cs.addresses(n)
    known = torch.ones((2, n), dtype=torch.bool)
    status = torch.zeros((2, n), dtype=torch.int64)
    inc = torch.full((2, n), 1414142122274, dtype=torch.int64)
    status[1, 5] = 1
    got = cs.view_checksums(addrs, known, status, inc)
    strings = [";".join("%s%s%d" % (a, cs.STATUS_STRINGS[int(status[r, j])], int(inc[r, j]))
                        for j, a in enumerate(addrs)) for r in range(2)]
    assert got.tolist() == [farmhash.hash32(s) for s in strings]
    assert got[0] != got[1]
    assert np.unique(got.numpy()).size == 2
