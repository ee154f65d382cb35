"""The SWIM protocol-period loop (lib/gossip/index.js rebuilt).

A self-rescheduling timer runs one protocol period at a time: pick the next
round-robin member (membership/iterator.js), direct-ping it, and on failure
fan out indirect probes (gossip/index.js:135-192).  The period adapts to
2x the p50 of observed tick latency, floored at ``minProtocolPeriod`` =
200 ms (gossip/index.js:42-55,194-196); the first tick is staggered by a
random 0..200 ms (gossip/index.js:48).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Optional

from ringpop_tpu_torch.gossip.ping_req_sender import send_ping_req
from ringpop_tpu_torch.gossip.ping_sender import send_ping
from ringpop_tpu_torch.utils.stats import Histogram

MIN_PROTOCOL_PERIOD_MS = 200  # gossip/index.js:194-196


class Gossip:
    def __init__(
        self,
        ringpop: Any,
        min_protocol_period_ms: int = MIN_PROTOCOL_PERIOD_MS,
        rng: Optional[random.Random] = None,
    ):
        self.ringpop = ringpop
        self.min_protocol_period_ms = min_protocol_period_ms
        self.is_stopped = True
        self.is_pinging = False
        self.protocol_periods = 0
        self.protocol_timing = Histogram()
        self.last_protocol_period: Optional[float] = None
        self.last_protocol_rate_ms: Optional[float] = None
        self.num_changes_disseminated = 0
        self._timer = None
        self._rng = rng or random.Random()
        self._lock = threading.Lock()

    # -- rate adaptation --------------------------------------------------

    def compute_protocol_delay_ms(self) -> float:
        """gossip/index.js:42-50: adaptive once a period has run; a random
        0..minProtocolPeriod stagger for the very first tick."""
        if self.protocol_periods:
            target = (self.last_protocol_period or 0) + (
                self.last_protocol_rate_ms or 0
            )
            return max(target - time.time() * 1000.0, self.min_protocol_period_ms)
        return self._rng.random() * self.min_protocol_period_ms

    def compute_protocol_rate_ms(self) -> float:
        """gossip/index.js:52-55: 2x observed p50, floored."""
        p50 = self.protocol_timing.percentiles([0.5])[0.5] or 0.0
        return max(p50 * 2.0, self.min_protocol_period_ms)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if not self.is_stopped:
            self.ringpop.logger.debug(
                "gossip has already started", extra={"local": self.ringpop.whoami()}
            )
            return
        self.ringpop.membership.shuffle()
        self.is_stopped = False
        self._run()
        self.ringpop.logger.debug(
            "ringpop gossip protocol started", extra={"local": self.ringpop.whoami()}
        )

    def stop(self) -> None:
        if self.is_stopped:
            self.ringpop.logger.warning(
                "gossip is already stopped", extra={"local": self.ringpop.whoami()}
            )
            return
        self.ringpop.timers.clear_timeout(self._timer)
        self._timer = None
        self.is_stopped = True
        self.ringpop.logger.debug(
            "ringpop gossip protocol stopped", extra={"local": self.ringpop.whoami()}
        )

    def _run(self) -> None:
        delay_ms = self.compute_protocol_delay_ms()
        self.ringpop.stat("timing", "protocol.delay", delay_ms)

        def fire():
            if self.is_stopped:
                return
            start = time.time()
            self.tick()
            elapsed_ms = (time.time() - start) * 1000.0
            self.protocol_timing.update(elapsed_ms)
            self.ringpop.stat("timing", "protocol.frequency", elapsed_ms)
            self.protocol_periods += 1
            self.last_protocol_period = time.time() * 1000.0
            self.last_protocol_rate_ms = self.compute_protocol_rate_ms()
            if not self.is_stopped:
                self._run()

        self._timer = self.ringpop.timers.set_timeout(fire, delay_ms / 1000.0)

    # -- one protocol period ---------------------------------------------

    def tick(self) -> None:
        """One period: iterate -> ping -> (on failure) ping-req.
        Overlapping periods are skipped via the isPinging guard
        (gossip/index.js:138-141)."""
        with self._lock:
            if self.is_pinging:
                self.ringpop.stat("increment", "gossip.tick.skipped")
                return
            self.is_pinging = True
        try:
            member = self.ringpop.member_iterator.next()
            if member is None:
                return
            ok, _ = send_ping(self.ringpop, member)
            if ok:
                self.ringpop.stat("increment", "ping.success")
                return
            if self.is_stopped:
                return
            self.ringpop.stat("increment", "ping.failure")
            send_ping_req(self.ringpop, member)
        finally:
            self.is_pinging = False

    def get_stats(self) -> dict:
        return {
            "protocolRate": self.compute_protocol_rate_ms(),
            "protocolPeriods": self.protocol_periods,
            "lastProtocolRate": self.last_protocol_rate_ms,
            "numChangesDisseminated": self.num_changes_disseminated,
            "protocolTiming": self.protocol_timing.to_dict(),
        }
