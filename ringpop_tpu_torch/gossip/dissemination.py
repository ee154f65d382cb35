"""Piggyback change dissemination (lib/gossip/dissemination.js rebuilt).

Membership changes ride on ping/ping-req bodies until each has been issued
``15 * ceil(log10(serverCount + 1))`` times (dissemination.js:38-55), then
drop out of the buffer.  The receive side filters changes the requester
itself originated (dissemination.js:91-98) and falls back to a **full sync**
— the entire membership — when it has no changes left but the checksums
disagree (dissemination.js:101-114).

Quirk preserved: piggyback counts bump when a change is *issued*, even if
the send later fails (dissemination.js:142-155 documents this as a TODO).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from ringpop_tpu_torch.models.membership.host import Update
from ringpop_tpu_torch.utils.config import EventEmitter


class Dissemination(EventEmitter):
    DEFAULT_MAX_PIGGYBACK_COUNT = 1  # dissemination.js:179
    PIGGYBACK_FACTOR = 15  # dissemination.js:180

    def __init__(self, ringpop: Any):
        super().__init__()
        self.ringpop = ringpop
        self.changes: Dict[str, Dict[str, Any]] = {}
        self.max_piggyback_count = self.DEFAULT_MAX_PIGGYBACK_COUNT

    # -- piggyback scaling ------------------------------------------------

    def adjust_max_piggyback_count(self) -> None:
        """15 * ceil(log10(serverCount + 1)) from the ring's server count
        (dissemination.js:38-55); emits when the bound changes."""
        server_count = self.ringpop.ring.get_server_count()
        prev = self.max_piggyback_count
        new = self.PIGGYBACK_FACTOR * math.ceil(math.log10(server_count + 1))
        if new != prev:
            self.max_piggyback_count = new
            self.ringpop.stat("gauge", "max-piggyback", new)
            self.emit("maxPiggybackCountAdjusted")

    # -- change buffer ----------------------------------------------------

    def record_change(self, change) -> None:
        if isinstance(change, Update):
            change = change.to_dict()
        self.changes[change["address"]] = dict(change, piggybackCount=0)

    def clear_changes(self) -> None:
        self.changes = {}

    def get_change_count(self) -> int:
        return len(self.changes)

    def full_sync(self) -> List[Dict[str, Any]]:
        """The entire membership as a changeset (dissemination.js:61-76)."""
        membership = self.ringpop.membership
        return [
            {
                "source": self.ringpop.whoami(),
                "address": m.address,
                "status": m.status,
                "incarnationNumber": m.incarnation_number,
            }
            for m in membership.members
        ]

    # -- issuing ----------------------------------------------------------

    def issue_as_sender(self) -> List[Dict[str, Any]]:
        return self._issue_changes()

    def issue_as_receiver(
        self,
        sender_addr: str,
        sender_incarnation_number: Optional[int],
        sender_checksum: Optional[int],
    ):
        """Changes for a ping response; full sync when empty + checksums
        differ.  Returns (changes, did_full_sync)."""

        def keep(change: Dict[str, Any]) -> bool:
            # filter changes the requester originated; all four fields must
            # be truthy before the comparison fires (dissemination.js:90-97)
            return not (
                sender_addr
                and sender_incarnation_number
                and change.get("source")
                and change.get("sourceIncarnationNumber")
                and change["source"] == sender_addr
                and change["sourceIncarnationNumber"]
                == sender_incarnation_number
            )

        changes = self._issue_changes(keep)
        if changes:
            return changes, False
        # a missing sender checksum still counts as a mismatch — the JS
        # `checksum !== senderChecksum` is true for undefined
        # (dissemination.js:101-114)
        if self.ringpop.membership.checksum != sender_checksum:
            self.ringpop.stat("increment", "full-sync")
            self.ringpop.logger.info(
                "ringpop dissemination full sync",
                extra={
                    "local": self.ringpop.whoami(),
                    "localChecksum": self.ringpop.membership.checksum,
                    "dest": sender_addr,
                    "destChecksum": sender_checksum,
                },
            )
            return self.full_sync(), True
        return [], False

    def _issue_changes(self, keep=None) -> List[Dict[str, Any]]:
        issued = []
        for address in list(self.changes.keys()):
            change = self.changes[address]
            # receiver-origin filter runs BEFORE the piggyback bump, so
            # filtered changes don't burn budget (dissemination.js:147-160)
            if keep is not None and not keep(change):
                self.ringpop.stat("increment", "filtered-change")
                continue
            # bump regardless of eventual send success (reference TODO quirk,
            # dissemination.js:142-155)
            change["piggybackCount"] += 1
            if change["piggybackCount"] > self.max_piggyback_count:
                del self.changes[address]
                continue
            issued.append(
                {
                    "id": change.get("id"),
                    "source": change.get("source"),
                    "sourceIncarnationNumber": change.get(
                        "sourceIncarnationNumber"
                    ),
                    "address": change["address"],
                    "status": change["status"],
                    "incarnationNumber": change["incarnationNumber"],
                }
            )
        self.ringpop.stat("gauge", "changes.disseminate", len(issued))
        return issued
