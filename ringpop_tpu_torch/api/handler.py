"""Sharded-channel handler (ringpop-handler.js rebuilt).

Wraps an application endpoint handler so requests carrying a shard key in
the ``sk`` head field route through the ring: local keys are handled
in-process, remote keys relay to their owner over the same endpoint
(ringpop-handler.js:73-104).  Endpoints on the blacklist pass straight
through (ringpop-handler.js:52-68).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from ringpop_tpu_torch.net.channel import RemoteError


class RingpopHandler:
    def __init__(
        self,
        ringpop: Any,
        handler: Callable[[Any, Any], Tuple[Any, Any]],
        endpoint: str,
        blacklist: Optional[Sequence[str]] = None,
        timeout_s: float = 30.0,
    ):
        self.ringpop = ringpop
        self.handler = handler
        self.endpoint = endpoint
        self.blacklist = set(blacklist or [])
        self.timeout_s = timeout_s

    def register(self, channel=None) -> None:
        (channel or self.ringpop.channel).register(self.endpoint, self)

    def __call__(self, head: Any, body: Any) -> Tuple[Any, Any]:
        if self.endpoint in self.blacklist:
            return self.handler(head, body)
        sk = (head or {}).get("sk") if isinstance(head, dict) else None
        if sk is None:
            self.ringpop.logger.warning(
                "ringpop handler got request without a shard key",
                extra={"endpoint": self.endpoint},
            )
            return self.handler(head, body)
        dest = self.ringpop.lookup(sk)
        if dest == self.ringpop.whoami():
            return self.handler(head, body)
        # relay to the owner (ringpop-handler.js:101-103)
        self.ringpop.stat("increment", "handler.relay")
        return self.ringpop.channel.request(
            dest, self.endpoint, head=head, body=body, timeout_s=self.timeout_s
        )
