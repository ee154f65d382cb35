"""In-process live-cluster fixture on the port's classes: N full Ringpop
nodes with real framed JSON-over-TCP channels on 127.0.0.1 (ports from the
OS) — tests/lib/cluster.py's ``LiveCluster``, copied, which is the
reference's ``testRingpopCluster`` (test/lib/test-ringpop-cluster.js:31-135).

Gossip is driven manually (``autoGossip: False`` + ``tick_all``) and every
node gets ``FakeTimers`` so suspicion clocks and proxy retry sleeps advance
virtually while the RPC plane stays real sockets.  ``kinds`` picks each
node's package: a sequence of ``(Ringpop, Channel, FakeTimers)`` classes,
one per node, so one cluster can hold nodes of both packages.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from ringpop_tpu_torch.api.ringpop import Ringpop
from ringpop_tpu_torch.net.channel import Channel
from ringpop_tpu_torch.net.timers import FakeTimers

PORT_KIND = (Ringpop, Channel, FakeTimers)


class LiveCluster:
    def __init__(self, n: int = 5, app: str = "integration-app",
                 options: Optional[dict] = None, tap=None,
                 kinds: Optional[Sequence[tuple]] = None):
        self.nodes: List = []
        for i in range(n):
            ringpop_cls, channel_cls, timers_cls = kinds[i] if kinds else PORT_KIND
            ch = channel_cls("127.0.0.1:0")
            host_port = ch.listen()
            rp = ringpop_cls(
                app, host_port, channel=ch, timers=timers_cls(),
                options=dict({"autoGossip": False}, **(options or {})), seed=i,
            )
            self.nodes.append(rp)
        self.hosts = [rp.whoami() for rp in self.nodes]
        if tap is not None:
            # pre-bootstrap sabotage hook (test-ringpop-cluster.js tap())
            tap(self)

    # -- lifecycle --------------------------------------------------------

    def bootstrap_all(self, timeout_s: float = 30.0) -> None:
        """Concurrent bootstrap against the shared hosts list, like
        tick-cluster's simultaneous child-process startup."""
        errors: List[tuple] = []

        def boot(rp) -> None:
            try:
                rp.bootstrap(self.hosts)
            except Exception as e:  # collected for the assert below
                errors.append((rp.whoami(), e))

        threads = [threading.Thread(target=boot, args=(rp,), daemon=True) for rp in self.nodes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
        assert not errors, errors
        assert all(rp.is_ready for rp in self.nodes)
        # start gossip so tick() runs its full path; the self-rescheduling
        # timer lands in FakeTimers, so protocol periods still only run when
        # the test calls tick_all()/advance_all()
        for rp in self.nodes:
            rp.gossip.start()

    def destroy_all(self) -> None:
        for rp in self.nodes:
            rp.destroy()

    # -- drive ------------------------------------------------------------

    def live(self) -> List:
        return [rp for rp in self.nodes if rp.is_ready and not rp.destroyed]

    def tick_all(self) -> None:
        # manual drive: a protocol period on every live node
        for rp in self.live():
            rp.gossip.tick()

    def advance_all(self, seconds: float) -> None:
        for rp in self.live():
            rp.timers.advance(seconds)

    def checksums(self) -> Dict[str, int]:
        return {rp.whoami(): rp.membership.checksum for rp in self.live()}

    def converged(self) -> bool:
        # all live checksums equal (scenario-runner.js:152-170)
        return len(set(self.checksums().values())) <= 1

    def tick_until_converged(self, max_ticks: int = 60) -> int:
        for i in range(max_ticks):
            self.tick_all()
            if self.converged():
                return i + 1
        raise AssertionError("no convergence after %d ticks: %r" % (max_ticks, self.checksums()))

    # -- queries ----------------------------------------------------------

    def node(self, i: int):
        return self.nodes[i]

    def status_of(self, viewer, address: str) -> Optional[str]:
        m = viewer.membership.find_member_by_address(address)
        return m.status if m is not None else None

    def statuses_of(self, address: str) -> Dict[str, Optional[str]]:
        return {rp.whoami(): self.status_of(rp, address)
                for rp in self.live() if rp.whoami() != address}
