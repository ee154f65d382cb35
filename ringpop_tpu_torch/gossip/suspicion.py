"""Suspicion subprotocol (lib/gossip/suspicion.js rebuilt).

A suspect member gets a 5-second clock; on expiry it is declared faulty
with the incarnation number captured from the update that started the
suspect period (suspicion.js:58-76 closure semantics) — a concurrently
bumped incarnation must ride out a fresh period.  Timers never run for
the local member, stop wholesale when the node leaves, and re-enable on
rejoin (suspicion.js:31-44,88-109).
"""

from __future__ import annotations

from typing import Any, Dict

DEFAULT_SUSPICION_TIMEOUT_MS = 5000  # suspicion.js:111-113


class Suspicion:
    def __init__(self, ringpop: Any, timeout_ms: int = DEFAULT_SUSPICION_TIMEOUT_MS):
        self.ringpop = ringpop
        self.period_ms = timeout_ms
        self.timers: Dict[str, Any] = {}
        self.stopped = False

    def start(self, member) -> None:
        address = getattr(member, "address", None) or member["address"]
        if self.stopped:
            self.ringpop.logger.debug(
                "cannot start a suspect period because suspicion protocol is stopped"
            )
            return
        if address == self.ringpop.whoami():
            self.ringpop.logger.debug(
                "cannot start a suspect period for the local member"
            )
            return
        if address in self.timers:
            self.stop(member)

        # capture the incarnation from the update that started this suspect
        # period; a concurrently-bumped incarnation must ride out a fresh
        # period before escalation (suspicion.js:67-70 closure semantics)
        if isinstance(member, dict):
            inc = member.get("incarnationNumber")
        else:
            inc = getattr(member, "incarnation_number", None)

        def expire():
            self.timers.pop(address, None)
            self.ringpop.logger.info(
                "ringpop member declares member faulty",
                extra={"local": self.ringpop.whoami(), "faulty": address},
            )
            self.ringpop.membership.make_faulty(address, inc)

        self.timers[address] = self.ringpop.timers.set_timeout(
            expire, self.period_ms / 1000.0
        )

    def stop(self, member) -> None:
        address = getattr(member, "address", None) or member["address"]
        handle = self.timers.pop(address, None)
        if handle is not None:
            self.ringpop.timers.clear_timeout(handle)

    def stop_all(self) -> None:
        self.stopped = True
        for address, handle in list(self.timers.items()):
            self.ringpop.timers.clear_timeout(handle)
            del self.timers[address]

    def reenable(self) -> None:
        if self.stopped:
            self.stopped = False
