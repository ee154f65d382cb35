"""Indirect-probe fan-out (lib/gossip/ping-req-sender.js rebuilt).

When the direct ping fails, fan out ``/protocol/ping-req`` to
``pingReqSize`` (3) random pingable members excluding the target
(ping-req-sender.js:293-296).  Outcomes (ping-req-sender.js:148-297):

- no eligible intermediaries -> the target is suspected immediately
  (ping-req-sender.js:162-169);
- any intermediary reports ``pingStatus: true`` -> the target is reachable;
- every responding intermediary reports ``pingStatus: false`` -> suspect;
- nothing but transport errors -> inconclusive, no state change.

Responses' piggybacked changes are applied either way.  Default timeout
5000 ms (index.js:114).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from ringpop_tpu_torch.net.channel import ChannelError, RemoteError

DEFAULT_PING_REQ_TIMEOUT_MS = 5000


class PingReqResult:
    def __init__(self, member, ok: bool, ping_status: Optional[bool], body=None):
        self.member = member
        self.ok = ok  # transport-level success
        self.ping_status = ping_status
        self.body = body


def send_ping_req(ringpop: Any, target, size: Optional[int] = None):
    """Returns True if the target was confirmed reachable, False if it was
    declared suspect, None if inconclusive."""
    size = size or ringpop.ping_req_size
    target_addr = getattr(target, "address", None) or target["address"]
    peers = ringpop.membership.get_random_pingable_members(
        size, excluding=[target_addr, ringpop.whoami()]
    )
    ringpop.stat("increment", "ping-req.send")

    if not peers:
        # no possible intermediaries: suspect straight away
        # (ping-req-sender.js:162-169)
        ringpop.membership.make_suspect(
            target_addr, _incarnation_of(ringpop, target)
        )
        return False

    results: List[PingReqResult] = [None] * len(peers)

    def probe(i: int, peer) -> None:
        body = {
            "checksum": ringpop.membership.checksum,
            "changes": ringpop.dissemination.issue_as_sender(),
            "source": ringpop.whoami(),
            "sourceIncarnationNumber": ringpop.membership.get_incarnation_number(),
            "target": target_addr,
        }
        try:
            _, res = ringpop.channel.request(
                peer.address,
                "/protocol/ping-req",
                head=None,
                body=body,
                timeout_s=ringpop.ping_req_timeout_ms / 1000.0,
            )
            results[i] = PingReqResult(peer, True, bool(res.get("pingStatus")), res)
        except (ChannelError, RemoteError):
            results[i] = PingReqResult(peer, False, None)

    threads = [
        threading.Thread(target=probe, args=(i, p), daemon=True)
        for i, p in enumerate(peers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(ringpop.ping_req_timeout_ms / 1000.0 + 1.0)

    responded = [r for r in results if r is not None and r.ok]
    for r in responded:
        if r.body and r.body.get("changes"):
            ringpop.membership.update(r.body["changes"])

    if any(r.ping_status for r in responded):
        ringpop.stat("increment", "ping-req.others.ping-status.true")
        return True
    if responded:
        # all intermediaries reached the middle hop but none reached the
        # target (ping-req-sender.js:249-262)
        ringpop.stat("increment", "ping-req.others.ping-status.false")
        ringpop.logger.info(
            "ringpop member declares member suspect",
            extra={"local": ringpop.whoami(), "suspect": target_addr},
        )
        ringpop.membership.make_suspect(
            target_addr, _incarnation_of(ringpop, target)
        )
        return False
    ringpop.stat("increment", "ping-req.inconclusive")
    return None


def _incarnation_of(ringpop: Any, target) -> Optional[int]:
    addr = getattr(target, "address", None) or target["address"]
    member = ringpop.membership.find_member_by_address(addr)
    if member is not None:
        return member.incarnation_number
    return getattr(target, "incarnation_number", None)
