"""Host-side SWIM membership state machine.

The reference's member/membership pair (ringpop-node lib/membership/
member.js, index.js) rebuilt in Python.  This is the *control-plane* model —
one real Ringpop node's membership list — and also the per-node parity oracle
the batched device simulator is lockstep-tested against
(ringpop_tpu_torch/parity/oracle.py).  A copy of the JAX package's
``models/membership/host.py``: the port imports nothing of it.

Semantics preserved exactly:
- SWIM update precedence (member.js:171-202): alive/suspect/faulty/leave ×
  incarnation-number comparison, including the leave quirks (nothing but a
  newer alive — or first leave — overrides leave).
- Local override (member.js:155-169): a node told it is suspect/faulty
  refutes by re-asserting alive with a fresh incarnation number.
- Checksum string ``addr+status+incarnation`` sorted by address, joined ';'
  (index.js:100-123), hashed with FarmHash32.
- Stashed pre-ready updates applied atomically by ``set()`` (index.js:208-247)
  with merged changesets and members appended (not random-positioned).
- New members inserted at a random join position (index.js:285,129-131).
- Flap-damping scores: +penalty per update, exponential decay
  (member.js:45-66,133-153) — with the decay timer driven by the host clock.
"""

from __future__ import annotations

import math
import random
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ringpop_tpu_torch.ops import native
from ringpop_tpu_torch.utils.config import EventEmitter


class Status:
    alive = "alive"
    faulty = "faulty"
    leave = "leave"
    suspect = "suspect"

    ALL = ("alive", "faulty", "leave", "suspect")


def _now_ms() -> int:
    return int(time.time() * 1000)


class Update:
    """Change record (lib/membership/update.js:26-40)."""

    def __init__(
        self,
        address: str,
        incarnation_number: Optional[int],
        status: str,
        local_member: Optional["Member"] = None,
        source: Optional[str] = None,
        source_incarnation_number: Optional[int] = None,
        id: Optional[str] = None,
        timestamp: Optional[int] = None,
        now: Callable[[], int] = _now_ms,
    ):
        self.address = address
        self.incarnation_number = incarnation_number
        self.status = status
        self.id = id or str(uuid.uuid4())
        if local_member is not None:
            self.source = local_member.address
            self.source_incarnation_number = local_member.incarnation_number
        else:
            self.source = source
            self.source_incarnation_number = source_incarnation_number
        self.timestamp = timestamp if timestamp is not None else now()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "source": self.source,
            "sourceIncarnationNumber": self.source_incarnation_number,
            "address": self.address,
            "status": self.status,
            "incarnationNumber": self.incarnation_number,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Update":
        return Update(
            address=d.get("address"),
            incarnation_number=d.get("incarnationNumber"),
            status=d.get("status"),
            source=d.get("source"),
            source_incarnation_number=d.get("sourceIncarnationNumber"),
            id=d.get("id"),
            timestamp=d.get("timestamp"),
        )


class LeaveUpdate(Update):
    def __init__(self, address, incarnation_number, local_member=None, **kw):
        super().__init__(address, incarnation_number, Status.leave, local_member, **kw)


class Member(EventEmitter):
    """Per-member state + the SWIM precedence rules (member.js)."""

    Status = Status

    def __init__(self, ringpop: Any, update: Update):
        super().__init__()
        self.ringpop = ringpop
        self.id = update.address
        self.address = update.address
        self.status = update.status
        self.incarnation_number = update.incarnation_number
        initial = ringpop.config.get("dampScoringInitial")
        damp = getattr(update, "damp_score", None)
        self.damp_score = damp if isinstance(damp, (int, float)) else initial
        self.damped_timestamp = getattr(update, "damped_timestamp", None)
        self.last_update_timestamp: Optional[int] = None
        self.last_update_damp_score = self.damp_score
        # True once the score crossed dampScoringSuppressLimit; cleared (with
        # a 'suppressRecovered' event) when decay brings it back below
        # dampScoringReuseLimit — the recovery side of the reference's
        # planned flap-damping subprotocol (membership/index.js:415-417 is a
        # TODO there; the reuse limit is config.js:69's knob for it)
        self.suppressed = False
        # the decay loop runs on a timer thread under real Timers while
        # updates arrive on gossip/server threads; damp state is a
        # read-modify-write either way (the reference is single-threaded)
        self._damp_lock = threading.Lock()
        self.now: Callable[[], int] = getattr(ringpop, "now", _now_ms)

    # -- damping ----------------------------------------------------------

    def decay_damp_score(self) -> None:
        with self._damp_lock:
            events = self._decay_damp_score_locked()
        for name, *args in events:
            self.emit(name, *args)

    def _decay_damp_score_locked(self) -> list:
        """Returns the events to emit (emission happens outside the lock:
        listeners may re-enter membership)."""
        config = self.ringpop.config
        if self.damp_score is None:
            self.damp_score = config.get("dampScoringInitial")
            return []
        time_since = (self.now() - (self.last_update_timestamp or 0)) / 1000.0
        decay = math.e ** (-time_since * math.log(2) / config.get("dampScoringHalfLife"))
        old = self.damp_score
        self.damp_score = max(
            round(self.last_update_damp_score * decay), config.get("dampScoringMin")
        )
        events = [("dampScoreDecayed", self.damp_score, old)]
        if self.suppressed and self.damp_score < config.get(
            "dampScoringReuseLimit"
        ):
            self.suppressed = False
            events.append(("suppressRecovered", self.damp_score))
        return events

    def _apply_update_penalty(self) -> None:
        config = self.ringpop.config
        with self._damp_lock:
            events = self._decay_damp_score_locked()
            self.damp_score = min(
                self.damp_score + config.get("dampScoringPenalty"),
                config.get("dampScoringMax"),
            )
            # lastUpdateDampScore is recorded here, atomically with the
            # penalty (the reference assigns it in evaluateUpdate right
            # after, member.js:111 — same value, same order)
            self.last_update_damp_score = self.damp_score
            if self.damp_score > config.get("dampScoringSuppressLimit"):
                self.suppressed = True
                events.append(("suppressLimitExceeded",))
        for name, *args in events:
            self.emit(name, *args)
        if self.damp_score > config.get("dampScoringSuppressLimit"):
            self.ringpop.logger.info(
                "ringpop member damp score exceeded suppress limit"
            )

    # -- the SWIM rules ---------------------------------------------------

    def _is_local_override(self, update: Update) -> bool:
        # member.js:155-169
        return self.ringpop.whoami() == self.address and update.status in (
            Status.faulty,
            Status.suspect,
        )

    def _is_other_override(self, update: Update) -> bool:
        # member.js:171-202
        u, s = update, self
        if u.status == Status.alive:
            return s.status in Status.ALL and u.incarnation_number > s.incarnation_number
        if u.status == Status.suspect:
            return (
                (s.status == Status.suspect and u.incarnation_number > s.incarnation_number)
                or (s.status == Status.faulty and u.incarnation_number > s.incarnation_number)
                or (s.status == Status.alive and u.incarnation_number >= s.incarnation_number)
            )
        if u.status == Status.faulty:
            return (
                (s.status == Status.suspect and u.incarnation_number >= s.incarnation_number)
                or (s.status == Status.faulty and u.incarnation_number > s.incarnation_number)
                or (s.status == Status.alive and u.incarnation_number >= s.incarnation_number)
            )
        if u.status == Status.leave:
            return (
                s.status != Status.leave
                and u.incarnation_number >= s.incarnation_number
            )
        return False

    def evaluate_update(self, update: Union[Update, Dict[str, Any]]) -> bool:
        """Apply the update if the precedence rules allow (member.js:71-122)."""
        if isinstance(update, dict):
            update = Update.from_dict({"address": self.address, **update})
        if self._is_local_override(update):
            # Override intended update. Assert aliveness!  (member.js:76-81)
            update = Update(
                address=update.address,
                incarnation_number=self.now(),
                status=Status.alive,
                source=update.source,
                source_incarnation_number=update.source_incarnation_number,
                id=update.id,
                timestamp=update.timestamp,
            )
        elif not self._is_other_override(update):
            return False

        old_status = self.status
        if self.status != update.status:
            self.status = update.status
            if (
                self.address == self.ringpop.whoami()
                and self.status == Status.leave
            ):
                self.ringpop.membership.emit(
                    "event",
                    {"name": "LocalMemberLeaveEvent", "member": self, "oldStatus": old_status},
                )

        if self.incarnation_number != update.incarnation_number:
            self.incarnation_number = update.incarnation_number

        if (
            self.ringpop.config.get("dampScoringEnabled")
            and update.address != self.ringpop.whoami()
        ):
            self._apply_update_penalty()  # records last_update_damp_score

        self.emit("updated", update)
        self.last_update_timestamp = self.now()
        return True

    def get_stats(self) -> Dict[str, Any]:
        return {
            "address": self.address,
            "status": self.status,
            "incarnationNumber": self.incarnation_number,
            "dampScore": self.damp_score,
        }


def merge_membership_changesets(ringpop: Any, changesets: Sequence[Sequence[Update]]) -> List[Update]:
    """Keep the highest-incarnation change per address, skipping the local
    address (lib/membership/merge.js:22-51)."""
    merge_index: Dict[str, Update] = {}
    for changes in changesets:
        for change in changes:
            if change.address == ringpop.whoami():
                continue
            existing = merge_index.get(change.address)
            if existing is None or existing.incarnation_number < change.incarnation_number:
                merge_index[change.address] = change
    return list(merge_index.values())


class Membership(EventEmitter):
    """Ordered member list + by-address index (lib/membership/index.js)."""

    def __init__(self, ringpop: Any, rng: Optional[random.Random] = None):
        super().__init__()
        self.ringpop = ringpop
        self.members: List[Member] = []
        self.members_by_address: Dict[str, Member] = {}
        self.checksum: Optional[int] = None
        self.stashed_updates: Optional[List[List[Update]]] = []
        self.local_member: Optional[Member] = None
        self.rng = rng or random.Random()
        self.decay_timer = None
        # bumping this invalidates any in-flight decay callback: an
        # on_timeout that captured an older generation must neither decay
        # nor re-arm (stop() during a firing callback would otherwise be
        # lost, leaving the loop running — or doubled after a restart)
        self._decay_gen = 0

    # -- checksum ---------------------------------------------------------

    def compute_checksum(self) -> int:
        start = time.time()
        prev = self.checksum
        self.checksum = native.hash32(self.generate_checksum_string())
        self.emit("checksumComputed")
        self.ringpop.stat("timing", "compute-checksum", start)
        self.ringpop.stat("gauge", "checksum", self.checksum)
        if prev != self.checksum:
            self._emit_checksum_update()
        return self.checksum

    def _emit_checksum_update(self) -> None:
        counts = {s: 0 for s in Status.ALL}
        for m in self.members:
            counts[m.status] = counts.get(m.status, 0) + 1
        self.emit(
            "checksumUpdate",
            {
                "local": self.ringpop.whoami(),
                "timestamp": _now_ms(),
                "checksum": self.checksum,
                "membershipStatusCounts": counts,
            },
        )

    def generate_checksum_string(self) -> str:
        # membership/index.js:100-123 — sorted by address, no separator
        # between fields, ';' between members
        parts = []
        for m in sorted(self.members, key=lambda m: m.address):
            parts.append("%s%s%d" % (m.address, m.status, m.incarnation_number))
        return ";".join(parts)

    # -- queries ----------------------------------------------------------

    def find_member_by_address(self, address: str) -> Optional[Member]:
        return self.members_by_address.get(address)

    def get_incarnation_number(self) -> Optional[int]:
        return self.local_member.incarnation_number if self.local_member else None

    def get_join_position(self) -> int:
        return int(self.rng.random() * len(self.members))

    def get_member_at(self, index: int) -> Member:
        return self.members[index]

    def get_member_count(self) -> int:
        return len(self.members)

    def has_member(self, member: Member) -> bool:
        return self.find_member_by_address(member.address) is not None

    def is_pingable(self, member: Member) -> bool:
        return member.address != self.ringpop.whoami() and member.status in (
            Status.alive,
            Status.suspect,
        )

    def get_random_pingable_members(self, n: int, excluding: Sequence[str]) -> List[Member]:
        eligible = [
            m
            for m in self.members
            if m.address not in excluding and self.is_pingable(m)
        ]
        self.rng.shuffle(eligible)
        return eligible[:n]

    def get_stats(self) -> Dict[str, Any]:
        return {
            "checksum": self.checksum,
            "members": sorted(
                (m.get_stats() for m in self.members), key=lambda s: s["address"]
            ),
        }

    # -- mutations --------------------------------------------------------

    def make_alive(self, address: str, incarnation_number: int) -> List[Update]:
        self.ringpop.stat("increment", "make-alive")
        is_local = address == self.ringpop.whoami()
        return self._update_member(
            Update(address, incarnation_number, Status.alive, self.local_member),
            is_local,
        )

    def make_faulty(self, address: str, incarnation_number: int) -> List[Update]:
        self.ringpop.stat("increment", "make-faulty")
        return self._update_member(
            Update(address, incarnation_number, Status.faulty, self.local_member)
        )

    def make_leave(self, address: str, incarnation_number: int) -> List[Update]:
        self.ringpop.stat("increment", "make-leave")
        return self._update_member(
            LeaveUpdate(address, incarnation_number, self.local_member)
        )

    def make_suspect(self, address: str, incarnation_number: int) -> List[Update]:
        self.ringpop.stat("increment", "make-suspect")
        return self._update_member(
            Update(address, incarnation_number, Status.suspect, self.local_member)
        )

    def set(self) -> None:
        """Atomically apply stashed pre-bootstrap updates (index.js:208-247)."""
        if self.ringpop.is_ready or self.stashed_updates is None:
            return
        if not self.stashed_updates:
            return

        updates = merge_membership_changesets(self.ringpop, self.stashed_updates)

        for update in updates:
            member = self._create_member(update)
            self.members.append(member)
            self.members_by_address[member.address] = member

        self.stashed_updates = None
        self.compute_checksum()
        self.emit("set", updates)

    def update(self, changes, is_local: bool = False) -> List[Update]:
        if isinstance(changes, (Update, dict)):
            changes = [changes]
        changes = [
            Update.from_dict(c) if isinstance(c, dict) else c for c in changes
        ]
        self.ringpop.stat("gauge", "changes.apply", len(changes))
        if not changes:
            return []

        # Buffer updates until ready (index.js:258-265).
        if not is_local and not self.ringpop.is_ready:
            if self.stashed_updates is not None:
                self.stashed_updates.append(changes)
            return []

        updates: List[Update] = []

        for change in changes:
            member = self.find_member_by_address(change.address)
            if member is None:
                member = self._create_member(change)
                if member.address == self.ringpop.whoami():
                    self.local_member = member
                self.members.insert(self.get_join_position(), member)
                self.members_by_address[member.address] = member
                updates.append(change)
                continue

            applied: List[Update] = []
            handler = member.once("updated", lambda u: applied.append(u))
            member.evaluate_update(change)
            member.remove_listener("updated", handler)
            updates.extend(applied)

        if updates:
            self.compute_checksum()
            self.emit("updated", updates)

        return updates

    def shuffle(self) -> None:
        self.rng.shuffle(self.members)

    def to_list(self) -> List[str]:
        return [m.address for m in self.members]

    def _create_member(self, update: Update) -> Member:
        member = Member(self.ringpop, update)
        member.on(
            "suppressLimitExceeded",
            lambda: self.emit("memberSuppressLimitExceeded", member),
        )
        member.on(
            "suppressRecovered",
            lambda score: self.emit("memberSuppressRecovered", member, score),
        )
        return member

    def _update_member(self, update: Update, is_local: bool = False) -> List[Update]:
        updates = self.update(update, is_local)
        if updates:
            self.ringpop.logger.debug(
                "ringpop member declares other member %s" % update.status
            )
        return updates

    # -- damping decay loop (membership/index.js:330-383) ----------------

    def start_damp_score_decayer(self) -> None:
        """Start the periodic damp-score decay loop (membership/
        index.js:330-350, interval config.js:62 dampScoringDecayInterval):
        every interval, every member's flap-penalty score decays
        exponentially toward dampScoringMin, so suppressed members recover
        *between* updates rather than only lazily at the next penalty.
        Idempotent; a no-op when dampScoringDecayEnabled is off or the
        context has no timer plane (bare fixtures).

        The generation bump invalidates any IN-FLIGHT timeout callback
        from a previous loop: a callback that fired (clearing
        ``decay_timer``) concurrently with this start() would otherwise
        pass its stale-generation check and re-arm a SECOND live loop
        alongside the one armed here."""
        if self.decay_timer is not None:
            return
        self._decay_gen += 1
        self._schedule_decay()

    def stop_damp_score_decayer(self) -> None:
        """membership/index.js:352-357."""
        self._decay_gen += 1
        if self.decay_timer is not None:
            timers = getattr(self.ringpop, "timers", None)
            if timers is not None:
                timers.clear_timeout(self.decay_timer)
            self.decay_timer = None

    def _schedule_decay(self) -> None:
        config = self.ringpop.config
        if not config.get("dampScoringDecayEnabled"):
            return
        timers = getattr(self.ringpop, "timers", None)
        if timers is None:
            return
        gen = self._decay_gen

        def on_timeout() -> None:
            if gen != self._decay_gen:
                return  # stopped (or restarted) while in flight
            self.decay_timer = None
            self.decay_members_damp_score()
            if gen != self._decay_gen:
                return  # stopped by a decay listener
            self._schedule_decay()  # loop until stopped or disabled

        self.decay_timer = timers.set_timeout(
            on_timeout, config.get("dampScoringDecayInterval") / 1000.0
        )

    def decay_members_damp_score(self) -> None:
        # snapshot: the sweep runs on the timer thread while joins insert
        # into self.members at random positions (index.js:285)
        for m in list(self.members):
            m.decay_damp_score()


class MembershipIterator:
    """Round-robin pingable-member iterator with reshuffle each full round
    (lib/membership/iterator.js:22-51)."""

    def __init__(self, ringpop: Any):
        self.ringpop = ringpop
        self.current_index = -1
        self.current_round = 0

    def next(self) -> Optional[Member]:
        visited: Dict[str, bool] = {}
        membership = self.ringpop.membership
        max_to_visit = membership.get_member_count()

        while len(visited) < max_to_visit:
            self.current_index += 1
            if self.current_index >= membership.get_member_count():
                self.current_index = 0
                self.current_round += 1
                membership.shuffle()
            member = membership.get_member_at(self.current_index)
            visited[member.address] = True
            if membership.is_pingable(member):
                return member
        return None
