"""The port's host membership (``models/membership/host.py``): the cases
of tests/models/test_member.py and test_membership.py on the port's
classes (their helper, tests/lib/fixtures.py, copied here), and a seeded
sequence of updates applied to a JAX and a port ``Membership`` with the
member lists and checksums equal after each one.  Equality is exact."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import pytest

from ringpop_tpu.models import membership as jmem
from ringpop_tpu.utils.config import Config as JConfig
from ringpop_tpu_torch.models import membership as membership_pkg
from ringpop_tpu_torch.models.membership import (
    Member,
    MembershipIterator,
    Status,
    Update,
    merge_membership_changesets,
)
from ringpop_tpu_torch.ops import farmhash32 as fh
from ringpop_tpu_torch.utils.config import Config
from ringpop_tpu_torch.utils.util import null_logger
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


# ---- helpers: tests/lib/fixtures.py on the port's classes ----


class FakeClock:
    """Deterministic Date.now() — starts at a realistic ms epoch and can be
    advanced manually (the reference uses time-mock timers similarly)."""

    def __init__(self, start_ms: int = 1414142122274):
        self.ms = start_ms

    def __call__(self) -> int:
        return self.ms

    def advance(self, ms: int) -> None:
        self.ms += ms


class RingpopFixture:
    """Minimal ringpop context: config/logger/stat/whoami + membership (the
    reference's test/lib/test-ringpop.js:25-68: a real membership stack with
    no transport, forced ready, local member alive)."""

    def __init__(self, host_port: str = "127.0.0.1:3000", ready: bool = True,
                 seed: Optional[dict] = None, clock: Optional[FakeClock] = None,
                 membership_module=None, config_cls=None):
        mod = membership_module or membership_pkg
        self.host_port = host_port
        self.is_ready = False
        self.logger = null_logger()
        self.config = (config_cls or Config)(self, seed)
        self.clock = clock or FakeClock()
        self.now = self.clock
        self.stats = []
        self.membership = mod.Membership(self, rng=random.Random(0xC0FFEE))
        if ready:
            self.membership.make_alive(self.host_port, self.now())
            self.is_ready = True

    def whoami(self) -> str:
        return self.host_port

    def stat(self, type_: str, key: str, value=None) -> None:
        self.stats.append((type_, key, value))


def make_iterator(rp: RingpopFixture) -> MembershipIterator:
    return MembershipIterator(rp)


# ---- the cases of tests/models/test_member.py ----

def add_second_member(rp, address="127.0.0.1:3001"):
    rp.membership.update(
        [{"address": address, "status": Status.alive, "incarnationNumber": 1}]
    )
    return rp.membership.find_member_by_address(address)


def test_damp_score_initialized():
    rp = RingpopFixture()
    m2 = add_second_member(rp)
    assert m2.damp_score == rp.config.get("dampScoringInitial")


def test_penalized_for_update():
    rp = RingpopFixture()
    m2 = add_second_member(rp)
    m2.evaluate_update(
        {"status": Status.suspect, "incarnationNumber": rp.now() + 1}
    )
    assert m2.damp_score != rp.config.get("dampScoringInitial")


def test_flaps_until_exceeds_suppress_limit():
    rp = RingpopFixture()
    rp.config.set("dampScoringMax", 1000)
    rp.config.set("dampScoringSuppressLimit", 500)
    rp.config.set("dampScoringPenalty", 251)  # 2 updates is all it'll take
    m2 = add_second_member(rp)
    exceeded = []
    m2.on("suppressLimitExceeded", lambda: exceeded.append(True))
    m2.evaluate_update({"status": Status.suspect, "incarnationNumber": rp.now() + 1})
    m2.evaluate_update({"status": Status.faulty, "incarnationNumber": rp.now() + 2})
    assert m2.damp_score > rp.config.get("dampScoringSuppressLimit")
    assert exceeded


def test_damp_score_never_exceeds_max():
    rp = RingpopFixture()
    rp.config.set("dampScoringMax", 1000)
    rp.config.set("dampScoringPenalty", 5000)
    m2 = add_second_member(rp)
    m2.evaluate_update({"status": Status.suspect, "incarnationNumber": rp.now() + 1})
    assert m2.damp_score == rp.config.get("dampScoringMax")


def test_penalized_in_penalty_increments():
    rp = RingpopFixture()
    rp.config.set("dampScoringMax", 1000)
    rp.config.set("dampScoringPenalty", 100)
    m2 = add_second_member(rp)
    for i in range(1, 4):
        m2.evaluate_update(
            {"status": Status.suspect, "incarnationNumber": rp.now() + i}
        )
        assert m2.damp_score == rp.config.get("dampScoringPenalty") * i


def decay_by(rp, member, term_ms):
    member.now = lambda: rp.clock() + term_ms
    member.decay_damp_score()


def test_decays_by_arbitrary_amount():
    rp = RingpopFixture()
    m2 = add_second_member(rp)
    m2.evaluate_update({"status": Status.suspect, "incarnationNumber": rp.now() + 1})
    orig = m2.damp_score
    decay_by(rp, m2, 1000 + 1)
    assert m2.damp_score < orig


def test_decayed_by_half():
    rp = RingpopFixture()
    m2 = add_second_member(rp)
    m2.evaluate_update({"status": Status.suspect, "incarnationNumber": rp.now() + 1})
    orig = m2.damp_score
    decay_by(rp, m2, rp.config.get("dampScoringHalfLife") * 1000)
    assert m2.damp_score == round(orig / 2)


def test_never_decays_below_min():
    rp = RingpopFixture()
    rp.config.set("dampScoringInitial", 0)
    rp.config.set("dampScoringPenalty", 100)
    rp.config.set("dampScoringMin", 100)
    rp.config.set("dampScoringMax", 1000)
    m2 = add_second_member(rp)
    i = 1
    while m2.damp_score < rp.config.get("dampScoringMax"):
        m2.evaluate_update(
            {"status": Status.suspect, "incarnationNumber": rp.now() + i}
        )
        i += 1
    decay_by(rp, m2, rp.config.get("dampScoringHalfLife") * 1000 * 4)
    assert m2.damp_score == rp.config.get("dampScoringMin")


def test_member_id_is_address():
    rp = RingpopFixture()
    address = "127.0.0.1:3000"
    member = Member(rp, Update(address, 1, Status.alive))
    assert member.id == address


def test_update_happens_synchronously_or_not_at_all():
    rp = RingpopFixture()
    address = "127.0.0.1:3001"
    inc = rp.now()
    member = Member(rp, Update(address, inc, Status.alive))
    emitted = []
    member.on("updated", lambda u: emitted.append(u))

    member.evaluate_update(
        {"address": address, "status": Status.suspect, "incarnationNumber": inc + 1}
    )
    assert emitted

    emitted.clear()
    member.evaluate_update(
        {"address": address, "status": Status.suspect, "incarnationNumber": inc + 1}
    )
    assert not emitted


# -- the full precedence table (member.js:171-202), exhaustively -------------


def test_precedence_table_exhaustive():
    statuses = [Status.alive, Status.suspect, Status.faulty, Status.leave]

    def expected(cur_status, cur_inc, upd_status, upd_inc):
        if upd_status == Status.alive:
            return upd_inc > cur_inc
        if upd_status == Status.suspect:
            if cur_status in (Status.suspect, Status.faulty):
                return upd_inc > cur_inc
            if cur_status == Status.alive:
                return upd_inc >= cur_inc
            return False  # cur leave
        if upd_status == Status.faulty:
            if cur_status == Status.suspect:
                return upd_inc >= cur_inc
            if cur_status == Status.faulty:
                return upd_inc > cur_inc
            if cur_status == Status.alive:
                return upd_inc >= cur_inc
            return False  # cur leave
        if upd_status == Status.leave:
            return cur_status != Status.leave and upd_inc >= cur_inc
        return False

    rp = RingpopFixture()
    for cur_status in statuses:
        for upd_status in statuses:
            for delta in (-1, 0, 1):
                cur_inc = 1000
                upd_inc = cur_inc + delta
                member = Member(
                    rp, Update("127.0.0.1:3009", cur_inc, cur_status)
                )
                applied = member.evaluate_update(
                    {
                        "address": "127.0.0.1:3009",
                        "status": upd_status,
                        "incarnationNumber": upd_inc,
                    }
                )
                want = expected(cur_status, cur_inc, upd_status, upd_inc)
                assert applied == want, (cur_status, upd_status, delta)
                if want:
                    assert member.status == upd_status
                    assert member.incarnation_number == upd_inc
                else:
                    assert member.status == cur_status
                    assert member.incarnation_number == cur_inc


def test_local_refute_on_suspect_and_faulty():
    # member.js:76-81,155-169: local member re-asserts alive with fresh
    # incarnation on suspect/faulty claims about itself
    for claim in (Status.suspect, Status.faulty):
        rp = RingpopFixture()
        local = rp.membership.local_member
        orig_inc = local.incarnation_number
        rp.clock.advance(5000)
        rp.membership.update(
            [
                {
                    "address": rp.whoami(),
                    "status": claim,
                    "incarnationNumber": orig_inc,
                }
            ]
        )
        assert local.status == Status.alive
        assert local.incarnation_number == rp.now()
        assert local.incarnation_number > orig_inc


def test_local_leave_is_not_refuted():
    # leave about the local member is applied (higher inc), not refuted —
    # membership_test.js 'change with higher incarnation number results in
    # leave override'
    rp = RingpopFixture()
    local = rp.membership.local_member
    rp.membership.update(
        [
            {
                "address": rp.whoami(),
                "status": Status.leave,
                "incarnationNumber": local.incarnation_number + 1,
            }
        ]
    )
    assert local.status == Status.leave


# ---- the cases of tests/models/test_membership.py ----

def test_checksum_changes_on_update():
    rp = RingpopFixture()
    rp.membership.make_alive("127.0.0.1:3001", rp.now())
    prev = rp.membership.checksum
    rp.membership.make_alive("127.0.0.1:3002", rp.now())
    assert rp.membership.checksum != prev


def test_checksum_string_format_and_hash():
    rp = RingpopFixture()
    rp.membership.make_alive("127.0.0.1:3001", 1414142122275)
    rp.membership.make_suspect("127.0.0.1:3001", 1414142122275)
    s = rp.membership.generate_checksum_string()
    local_inc = rp.membership.local_member.incarnation_number
    assert s == (
        "127.0.0.1:3000alive%d;127.0.0.1:3001suspect1414142122275" % local_inc
    )
    assert rp.membership.checksum == fh.hash32(s)


def test_suspect_faulty_update_refutes_local():
    for status in (Status.suspect, Status.faulty):
        rp = RingpopFixture()
        local = rp.membership.local_member
        prev_inc = local.incarnation_number
        rp.clock.advance(1)
        rp.membership.update(
            [
                {
                    "address": local.address,
                    "status": status,
                    "incarnationNumber": prev_inc,
                }
            ]
        )
        assert local.status == Status.alive
        assert local.incarnation_number > prev_inc


def test_alive_to_faulty_without_suspect():
    rp = RingpopFixture()
    rp.membership.make_alive("127.0.0.1:3001", rp.now())
    member = rp.membership.find_member_by_address("127.0.0.1:3001")

    # lower incarnation: no override
    rp.membership.update(
        [
            {
                "address": member.address,
                "status": Status.faulty,
                "incarnationNumber": member.incarnation_number - 1,
            }
        ]
    )
    assert member.status == Status.alive

    # same incarnation: faulty overrides alive
    rp.membership.update(
        [
            {
                "address": member.address,
                "status": Status.faulty,
                "incarnationNumber": member.incarnation_number,
            }
        ]
    )
    assert member.status == Status.faulty


def test_update_buffered_until_ready():
    rp = RingpopFixture(ready=False)
    rp.membership.make_alive(rp.whoami(), rp.now())  # local: applied directly

    # non-local updates stash until set()
    rp.membership.update(
        [{"address": "127.0.0.1:3001", "status": Status.alive, "incarnationNumber": 1}]
    )
    assert rp.membership.get_member_count() == 1
    assert len(rp.membership.stashed_updates) == 1

    rp.membership.set()
    assert rp.membership.get_member_count() == 2
    assert rp.membership.stashed_updates is None
    assert rp.membership.checksum is not None


def test_set_merges_stashed_changesets():
    rp = RingpopFixture(ready=False)
    rp.membership.make_alive(rp.whoami(), rp.now())
    rp.membership.update(
        [{"address": "127.0.0.1:3001", "status": Status.alive, "incarnationNumber": 1}]
    )
    rp.membership.update(
        [{"address": "127.0.0.1:3001", "status": Status.faulty, "incarnationNumber": 5}]
    )
    rp.membership.set()
    m = rp.membership.find_member_by_address("127.0.0.1:3001")
    # highest incarnation wins in the merge (merge.js:39-41)
    assert m.status == Status.faulty
    assert m.incarnation_number == 5


def test_changeset_merge_skips_local_and_keeps_highest():
    rp = RingpopFixture()
    cs1 = [
        Update("127.0.0.1:3001", 1, Status.alive),
        Update(rp.whoami(), 99, Status.faulty),
    ]
    cs2 = [Update("127.0.0.1:3001", 3, Status.suspect)]
    merged = merge_membership_changesets(rp, [cs1, cs2])
    assert len(merged) == 1
    assert merged[0].incarnation_number == 3
    assert merged[0].status == Status.suspect


def test_get_random_pingable_members_excludes():
    rp = RingpopFixture()
    for i in range(1, 6):
        rp.membership.make_alive("127.0.0.1:300%d" % i, rp.now())
    got = rp.membership.get_random_pingable_members(10, ["127.0.0.1:3001"])
    addrs = {m.address for m in got}
    assert "127.0.0.1:3001" not in addrs
    assert rp.whoami() not in addrs  # local never pingable
    assert len(got) == 4

    two = rp.membership.get_random_pingable_members(2, [])
    assert len(two) == 2


def test_iterator_round_robin_visits_all_pingable():
    rp = RingpopFixture()
    others = ["127.0.0.1:300%d" % i for i in range(1, 5)]
    for a in others:
        rp.membership.make_alive(a, rp.now())
    it = make_iterator(rp)
    seen = [it.next().address for _ in range(len(others))]
    assert sorted(seen) == sorted(others)  # one full round hits each once
    # second round revisits (reshuffled)
    seen2 = [it.next().address for _ in range(len(others))]
    assert sorted(seen2) == sorted(others)


def test_iterator_skips_faulty_and_local():
    rp = RingpopFixture()
    rp.membership.make_alive("127.0.0.1:3001", rp.now())
    rp.membership.make_alive("127.0.0.1:3002", rp.now())
    rp.membership.make_faulty("127.0.0.1:3002", rp.now())
    it = make_iterator(rp)
    for _ in range(6):
        m = it.next()
        assert m.address == "127.0.0.1:3001"


def test_iterator_returns_none_when_no_pingable():
    rp = RingpopFixture()
    it = make_iterator(rp)
    assert it.next() is None  # only the local member exists


def test_new_member_inserted_at_join_position():
    rp = RingpopFixture()
    for i in range(1, 10):
        rp.membership.make_alive("127.0.0.1:30%02d" % i, rp.now())
    # members list isn't (necessarily) in insertion order; address index works
    assert rp.membership.get_member_count() == 10
    for i in range(1, 10):
        assert rp.membership.find_member_by_address("127.0.0.1:30%02d" % i)


# ---- the port's Membership against the JAX package's ----


def _view(mem):
    return [(m.address, m.status, m.incarnation_number) for m in mem.members]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_updates_equal_jax(seed):
    """The same seeded sequence of updates (new members, every status,
    older / equal / newer incarnations, the local member refuting, bulk
    changesets) applied to a JAX and a port ``Membership``: the applied
    updates, the member list (order included), the checksum string and the
    checksum are equal after each one."""
    rng = np.random.default_rng(seed)
    clock_p, clock_j = FakeClock(), FakeClock()
    port = RingpopFixture(clock=clock_p)
    ref = RingpopFixture(clock=clock_j, membership_module=jmem, config_cls=JConfig)
    pool = ["127.0.0.1:%d" % (3000 + i) for i in range(12)]
    statuses = [Status.alive, Status.suspect, Status.faulty, Status.leave]
    base = clock_p()
    for step in range(120):
        clock_p.advance(int(rng.integers(0, 3)))
        clock_j.ms = clock_p.ms
        batch = []
        for _ in range(int(rng.integers(1, 4))):
            addr = pool[int(rng.integers(len(pool)))]
            batch.append({
                "address": addr,
                "status": statuses[int(rng.integers(4))],
                "incarnationNumber": base + int(rng.integers(0, 6)),
                "source": pool[int(rng.integers(len(pool)))],
                "sourceIncarnationNumber": base,
            })
        got = port.membership.update([dict(u) for u in batch])
        want = ref.membership.update([dict(u) for u in batch])
        assert [(u.address, u.status, u.incarnation_number) for u in got] == [
            (u.address, u.status, u.incarnation_number) for u in want], step
        assert _view(port.membership) == _view(ref.membership), step
        assert (port.membership.generate_checksum_string()
                == ref.membership.generate_checksum_string()), step
        assert port.membership.checksum == ref.membership.checksum, step
