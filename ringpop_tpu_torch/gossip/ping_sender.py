"""Direct-ping sender (lib/gossip/ping-sender.js rebuilt).

One ``/protocol/ping`` request per protocol period: body carries the local
checksum, the piggybacked changes, and the sender identity
(ping-sender.js:70-76); response changes are applied to membership
(ping-sender.js:30-43).  Default timeout 1500 ms (index.js:115).
"""

from __future__ import annotations

from typing import Any, Optional

from ringpop_tpu_torch.net.channel import ChannelError, RemoteError

DEFAULT_PING_TIMEOUT_MS = 1500


class PingSender:
    def __init__(self, ringpop: Any, member, timeout_ms: Optional[int] = None):
        self.ringpop = ringpop
        self.address = getattr(member, "address", None) or member["address"]
        self.timeout_ms = timeout_ms or ringpop.ping_timeout_ms

    def send(self):
        """Returns (ok: bool, response_body|None)."""
        body = {
            "checksum": self.ringpop.membership.checksum,
            "changes": self.ringpop.dissemination.issue_as_sender(),
            "source": self.ringpop.whoami(),
            "sourceIncarnationNumber": self.ringpop.membership.get_incarnation_number(),
        }
        self.ringpop.stat("increment", "ping.send")
        if self.ringpop.debug_flag_enabled("ping"):
            self.ringpop.logger.info(
                "ping send",
                extra={"local": self.ringpop.whoami(), "member": self.address},
            )
        try:
            _, res = self.ringpop.channel.request(
                self.address,
                "/protocol/ping",
                head=None,
                body=body,
                timeout_s=self.timeout_ms / 1000.0,
            )
        except (ChannelError, RemoteError):
            return False, None
        if res and res.get("changes"):
            self.ringpop.membership.update(res["changes"])
        return True, res


def send_ping(ringpop: Any, member, timeout_ms: Optional[int] = None):
    return PingSender(ringpop, member, timeout_ms).send()
