"""The port's gossip layer: the cases of tests/gossip/ (dissemination,
suspicion, the gossip loop, damping decay and the membership-update
rollup) on the port's classes.  Each file's stub context is renamed after
its file so the cases can share a module."""

from __future__ import annotations

from ringpop_tpu_torch.api.ringpop import Ringpop
from ringpop_tpu_torch.gossip.dissemination import Dissemination
from ringpop_tpu_torch.gossip.gossip import Gossip
from ringpop_tpu_torch.gossip.suspicion import Suspicion
from ringpop_tpu_torch.net.timers import FakeTimers
from ringpop_tpu_torch.utils.rollup import MembershipUpdateRollup


# ---- the cases of tests/gossip/test_dissemination.py ----

LOCAL = "127.0.0.1:3000"
PEER = "127.0.0.1:3001"


class DissemStubRing:
    def __init__(self, count=3):
        self.count = count

    def get_server_count(self):
        return self.count


class DissemStubMembership:
    def __init__(self):
        self.checksum = 12345
        self.members = []


class DissemStubRingpop:
    def __init__(self):
        self.ring = DissemStubRing()
        self.membership = DissemStubMembership()
        self.stats = []

        class _Log:
            def info(self, *a, **k):
                pass

            debug = warning = error = info

        self.logger = _Log()

    def whoami(self):
        return LOCAL

    def stat(self, type_, key, value=None):
        self.stats.append((type_, key, value))


def change(addr=PEER, source=LOCAL, source_inc=1414142122274):
    return {
        "id": "id-1",
        "source": source,
        "sourceIncarnationNumber": source_inc,
        "address": addr,
        "status": "alive",
        "incarnationNumber": 1414142122274,
    }


def test_issue_as_sender_bumps_and_expires():
    d = Dissemination(DissemStubRingpop())
    d.max_piggyback_count = 2
    d.record_change(change())
    assert len(d.issue_as_sender()) == 1
    assert len(d.issue_as_sender()) == 1
    # third issue exceeds the max: dropped from the buffer, not issued
    assert d.issue_as_sender() == []
    assert d.get_change_count() == 0


def test_receiver_origin_filter_does_not_consume_budget():
    d = Dissemination(DissemStubRingpop())
    d.max_piggyback_count = 2
    origin_inc = 999
    d.record_change(change(source=PEER, source_inc=origin_inc))
    # the originating peer pings us many times: always filtered, and the
    # filtered issues must not bump piggybackCount toward expiry
    for _ in range(10):
        changes, full_sync = d.issue_as_receiver(PEER, origin_inc, 12345)
        assert changes == []
        assert not full_sync
    assert d.get_change_count() == 1
    # a different receiver still gets the change afterwards
    changes, _ = d.issue_as_receiver("127.0.0.1:3002", 5, 12345)
    assert [c["address"] for c in changes] == [PEER]


def test_filtered_change_stat_incremented():
    rp = DissemStubRingpop()
    d = Dissemination(rp)
    d.record_change(change(source=PEER, source_inc=7))
    d.issue_as_receiver(PEER, 7, rp.membership.checksum)
    assert ("increment", "filtered-change", None) in rp.stats


def test_filter_requires_all_fields_truthy():
    # sourceIncarnationNumber None/0 on both sides must NOT trigger the
    # filter (reference truthiness guard, dissemination.js:90-97)
    d = Dissemination(DissemStubRingpop())
    d.record_change(change(source=PEER, source_inc=None))
    changes, _ = d.issue_as_receiver(PEER, None, 12345)
    assert len(changes) == 1

    d2 = Dissemination(DissemStubRingpop())
    d2.record_change(change(source=PEER, source_inc=7))
    # sender matches on address but not incarnation: issued
    changes, _ = d2.issue_as_receiver(PEER, 8, 12345)
    assert len(changes) == 1


def test_full_sync_on_checksum_mismatch_when_empty():
    rp = DissemStubRingpop()

    class M:
        address = PEER
        status = "alive"
        incarnation_number = 1

    rp.membership.members = [M()]
    d = Dissemination(rp)
    changes, full_sync = d.issue_as_receiver(PEER, 1, rp.membership.checksum + 1)
    assert full_sync and len(changes) == 1
    changes, full_sync = d.issue_as_receiver(PEER, 1, rp.membership.checksum)
    assert changes == [] and not full_sync


def test_max_piggyback_scales_with_server_count():
    rp = DissemStubRingpop()
    d = Dissemination(rp)
    rp.ring.count = 9  # ceil(log10(10)) = 1
    d.adjust_max_piggyback_count()
    assert d.max_piggyback_count == 15
    rp.ring.count = 1000  # ceil(log10(1001)) = 4... log10(1001)≈3.0004 → 4
    d.adjust_max_piggyback_count()
    assert d.max_piggyback_count == 60


# ---- the cases of tests/gossip/test_suspicion.py ----

LOCAL = "127.0.0.1:3000"
SUSPECT = "127.0.0.1:3001"


class SuspStubMembership:
    def __init__(self):
        self.faulty_calls = []

    def make_faulty(self, address, incarnation_number):
        self.faulty_calls.append((address, incarnation_number))


class SuspStubRingpop:
    def __init__(self):
        self.membership = SuspStubMembership()
        self.timers = FakeTimers()

        class _Log:
            def info(self, *a, **k):
                pass

            debug = warning = error = info

        self.logger = _Log()

    def whoami(self):
        return LOCAL


def update(addr=SUSPECT, inc=100):
    return {"address": addr, "status": "suspect", "incarnationNumber": inc}


def test_expiry_declares_faulty_with_started_incarnation():
    rp = SuspStubRingpop()
    s = Suspicion(rp)
    s.start(update(inc=100))
    rp.timers.advance(5.0)
    assert rp.membership.faulty_calls == [(SUSPECT, 100)]


def test_restart_uses_fresh_incarnation_and_resets_clock():
    rp = SuspStubRingpop()
    s = Suspicion(rp)
    s.start(update(inc=100))
    rp.timers.advance(3.0)
    # refuted-then-resuspected with a newer incarnation: old timer cancelled,
    # a full fresh period must elapse before faulty, with the new incarnation
    s.start(update(inc=200))
    rp.timers.advance(3.0)  # 6s since first start, 3s since restart
    assert rp.membership.faulty_calls == []
    rp.timers.advance(2.5)
    assert rp.membership.faulty_calls == [(SUSPECT, 200)]


def test_never_for_local_member():
    rp = SuspStubRingpop()
    s = Suspicion(rp)
    s.start(update(addr=LOCAL))
    rp.timers.advance(10.0)
    assert rp.membership.faulty_calls == []


def test_stop_all_and_reenable():
    rp = SuspStubRingpop()
    s = Suspicion(rp)
    s.start(update())
    s.stop_all()
    rp.timers.advance(10.0)
    assert rp.membership.faulty_calls == []
    # while stopped, new periods cannot start
    s.start(update())
    rp.timers.advance(10.0)
    assert rp.membership.faulty_calls == []
    s.reenable()
    s.start(update(inc=300))
    rp.timers.advance(5.0)
    assert rp.membership.faulty_calls == [(SUSPECT, 300)]


def test_stop_single_member():
    rp = SuspStubRingpop()
    s = Suspicion(rp)
    s.start(update())
    s.stop(update())
    rp.timers.advance(10.0)
    assert rp.membership.faulty_calls == []


# ---- the cases of tests/gossip/test_gossip_loop.py ----

class LoopStubRingpop:
    def __init__(self):
        from ringpop_tpu_torch.net.timers import FakeTimers

        self.timers = FakeTimers()

        class _Log:
            def debug(self, *a, **k):
                pass

            info = warning = error = debug

        self.logger = _Log()
        self.stats = []

    def whoami(self):
        return "127.0.0.1:3000"

    def stat(self, t, k, v=None):
        self.stats.append((t, k))


def test_first_tick_staggered_within_min_period():
    import random

    g = Gossip(LoopStubRingpop(), rng=random.Random(7))
    delays = {g.compute_protocol_delay_ms() for _ in range(20)}
    assert all(0 <= d < g.min_protocol_period_ms for d in delays)
    assert len(delays) > 1  # actually random, not constant


def test_rate_is_twice_p50_floored():
    g = Gossip(LoopStubRingpop())
    # no observations: floored at the minimum period
    assert g.compute_protocol_rate_ms() == g.min_protocol_period_ms
    for ms in (10.0, 20.0, 30.0):
        g.protocol_timing.update(ms)
    # p50=20 -> 2x = 40 < 200 floor
    assert g.compute_protocol_rate_ms() == g.min_protocol_period_ms
    for ms in (400.0, 500.0, 600.0, 700.0):
        g.protocol_timing.update(ms)
    assert g.compute_protocol_rate_ms() > g.min_protocol_period_ms


def test_start_stop_idempotent():
    class M:
        def shuffle(self):
            pass

    rp = LoopStubRingpop()
    rp.membership = M()
    g = Gossip(rp)
    assert g.is_stopped
    g.start()
    assert not g.is_stopped
    g.start()  # no-op
    g.stop()
    assert g.is_stopped
    g.stop()  # warns, no crash


# ---- the cases of tests/gossip/test_damp_decay.py ----

def make_ringpop(**options):
    timers = FakeTimers()
    rp = Ringpop(
        "test-app", "127.0.0.1:3000", timers=timers, options=options
    )
    # force-ready without a transport (test-ringpop.js:25-68 does the same)
    rp.is_ready = True
    rp.membership.make_alive(rp.whoami(), timers.now_ms())
    rp.membership.make_alive("127.0.0.1:3001", timers.now_ms())
    return rp, timers


def penalize(rp, timers, address="127.0.0.1:3001"):
    """One flap penalty: any applied update adds dampScoringPenalty.

    A fresh-incarnation ALIVE update is the penalty vehicle (it always
    overrides) — deliberately not make_suspect, whose facade wiring also
    starts a 5 s suspicion timer that would fire during advance() and
    re-penalize the member via makeFaulty mid-test."""
    member = rp.membership.find_member_by_address(address)
    rp.membership.make_alive(address, member.incarnation_number + 1)
    return rp.membership.find_member_by_address(address)


def test_decayer_runs_without_updates():
    """Scores decay BETWEEN updates — the round-4 gap: the method existed
    but nothing ever called it, so a penalized member's score froze until
    its next penalty."""
    rp, timers = make_ringpop()
    member = penalize(rp, timers)
    assert member.damp_score == 500  # dampScoringPenalty default

    # one half-life with NO further updates
    timers.advance(60.0)
    assert member.damp_score < 500, (
        "damp score must decay between updates (decayer not running?)"
    )
    # 60 s = one dampScoringHalfLife: score ~ 500 * 0.5, rounded per tick
    assert abs(member.damp_score - 250) <= 5


def test_decay_emits_damp_score_decayed():
    rp, timers = make_ringpop()
    member = penalize(rp, timers)
    seen = []
    member.on("dampScoreDecayed", lambda new, old: seen.append((new, old)))
    timers.advance(3.0)
    assert len(seen) == 3  # one per 1 s interval
    news = [new for new, _ in seen]
    assert news == sorted(news, reverse=True)  # monotone decay
    assert all(new <= old for new, old in seen)


def test_suppress_limit_crossing_both_ways():
    rp, timers = make_ringpop(
        dampScoringSuppressLimit=400, dampScoringReuseLimit=300
    )
    suppressed, recovered = [], []
    rp.on("memberSuppressLimitExceeded", lambda m: suppressed.append(m))
    rp.on("memberSuppressRecovered", lambda m, s: recovered.append((m, s)))

    member = penalize(rp, timers)  # score 500 > 400
    assert member.suppressed
    assert [m.address for m in suppressed] == ["127.0.0.1:3001"]
    assert not recovered

    # decay to < 300 (reuse limit): 500 * e^(-t ln2 / 60) < 300 at t ~ 45 s
    timers.advance(60.0)
    assert recovered and recovered[0][0] is member
    assert not member.suppressed
    assert member.damp_score < 300
    # stats carried the signal too
    assert any("suppress-limit-exceeded" in (k or "") for k in rp.stat_keys)
    assert any("suppress-recovered" in (k or "") for k in rp.stat_keys)


def test_destroy_stops_decayer():
    rp, timers = make_ringpop()
    member = penalize(rp, timers)
    rp.destroy()
    before = member.damp_score
    timers.advance(10.0)
    assert member.damp_score == before  # no decay after destroy


def test_decayer_disabled_by_config():
    rp, timers = make_ringpop(dampScoringDecayEnabled=False)
    member = penalize(rp, timers)
    timers.advance(10.0)
    assert member.damp_score == 500  # lazy decay only, on next penalty


def test_start_during_inflight_callback_does_not_double_arm():
    """Regression: a start() landing while a decay callback is mid-flight
    (after it cleared decay_timer, before it re-armed) must not leave TWO
    live loops.  start_damp_score_decayer bumps the generation, so the
    in-flight callback's re-arm is suppressed and exactly one loop
    survives.  The interleave is reproduced with a decay listener — it
    runs at precisely the decay_timer=None / re-arm gap."""
    rp, timers = make_ringpop()
    member = penalize(rp, timers)
    membership = rp.membership

    member.once(
        "dampScoreDecayed",
        lambda *a: membership.start_damp_score_decayer(),
    )
    timers.advance(1.0)  # callback: decay -> concurrent start() -> re-arm

    seen = []
    member.on("dampScoreDecayed", lambda new, old: seen.append(new))
    timers.advance(3.0)
    assert len(seen) == 3, (
        "decay loop double-armed: %d firings in 3 intervals" % len(seen)
    )

    # and the surviving loop still stops cleanly
    membership.stop_damp_score_decayer()
    timers.advance(3.0)
    assert len(seen) == 3


def test_decay_disabled_mid_run_stops_loop():
    rp, timers = make_ringpop()
    member = penalize(rp, timers)
    timers.advance(1.0)
    after_one = member.damp_score
    assert after_one < 500
    rp.config.set("dampScoringDecayEnabled", False)
    # the already-armed timer still fires once (the reference's schedule()
    # checks the flag only when re-arming, index.js:338-341) ...
    timers.advance(1.0)
    after_two = member.damp_score
    # ... and then the loop is dead
    timers.advance(10.0)
    assert member.damp_score == after_two


# ---- the cases of tests/gossip/test_rollup.py ----

class RollupStubRingpop:
    def __init__(self):
        self.timers = FakeTimers()
        self.debug_logs = []

        class M:
            checksum = 123

        self.membership = M()

        outer = self

        class _Log:
            def debug(self, msg, extra=None):
                outer.debug_logs.append((msg, extra))

            info = warning = error = debug

        self.logger = _Log()

    def whoami(self):
        return "127.0.0.1:3000"


def upd(addr, status="alive", inc=1):
    return {"address": addr, "status": status, "incarnationNumber": inc}


def test_flush_after_quiet_interval():
    rp = RollupStubRingpop()
    r = MembershipUpdateRollup(rp, flush_interval_ms=5000)
    r.track_updates([upd("a:1"), upd("b:2")])
    assert r._num_updates() == 2
    assert not rp.debug_logs
    rp.timers.advance(5.5)  # quiet interval elapses -> timer flush
    assert r.buffer == {}
    assert len(rp.debug_logs) == 1
    _, extra = rp.debug_logs[0]
    assert extra["updateCount"] == 2
    assert set(extra["updates"]) == {"a:1", "b:2"}


def test_force_flush_at_max_updates():
    rp = RollupStubRingpop()
    r = MembershipUpdateRollup(rp, flush_interval_ms=5000, max_num_updates=3)
    r.track_updates([upd("a:1"), upd("a:1")])  # same address: 2 updates
    assert not rp.debug_logs
    r.track_updates([upd("b:2")])  # hits the max -> immediate flush
    assert len(rp.debug_logs) == 1
    assert rp.debug_logs[0][1]["updateCount"] == 3
    assert r.buffer == {}


def test_flushed_event_and_destroy_cancels_timer():
    rp = RollupStubRingpop()
    r = MembershipUpdateRollup(rp, flush_interval_ms=5000)
    flushes = []
    r.on("flushed", lambda *a: flushes.append(1))
    r.track_updates([upd("a:1")])
    r.destroy()
    rp.timers.advance(10.0)
    assert not flushes  # destroyed before the quiet flush fired
    r.flush_buffer()  # manual flush still works
    assert flushes == [1]
