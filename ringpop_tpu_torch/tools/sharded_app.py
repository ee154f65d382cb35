"""A sharded app on the port's live node: the counterpart of the JAX
package's ``examples/sharded_app.py`` (the analog of ringpop-node's
``examples/tchannel-forwarding.js``).

Three port ``Ringpop`` nodes form a ring; each registers an app endpoint
``hello`` behind an ``api.handler.RingpopHandler``.  A request carrying a
shard key (the ``sk`` header) sent to any node is answered by the key's
ring owner, relayed when the owner is another node.

Usage: python -m ringpop_tpu_torch.tools.sharded_app

The nodes hold no tensor, so the tool takes no ``--device`` and needs no
card.
"""

from __future__ import annotations

import argparse
import sys
import threading
from typing import List, Optional, Sequence, Tuple

from ringpop_tpu_torch.api.handler import RingpopHandler
from ringpop_tpu_torch.api.ringpop import Ringpop
from ringpop_tpu_torch.net.channel import Channel

KEYS = ("alpha", "bravo", "charlie", "delta")


class App:
    def __init__(self, name: str):
        self.name = name
        self.channel = Channel("127.0.0.1:0")
        host_port = self.channel.listen()
        self.ringpop = Ringpop("example-app", host_port, channel=self.channel,
                               options={"autoGossip": False})

        def hello(head, body):
            # answered by the sk owner, wherever the request entered
            return None, "hello from %s for %s" % (self.name, head.get("sk"))

        RingpopHandler(self.ringpop, hello, "hello").register()

    def bootstrap(self, hosts):
        self.ringpop.bootstrap(hosts)

    def whoami(self) -> str:
        return self.ringpop.whoami()


def run(keys: Sequence[str] = KEYS, nodes: int = 3) -> Tuple[List[str], List[tuple]]:
    """Start ``nodes`` apps, converge them, send each key to the first;
    returns the hosts and ``(key, owner, answering app, body)`` rows."""
    apps = [App("app%d" % i) for i in range(nodes)]
    try:
        hosts = [a.whoami() for a in apps]
        threads = [threading.Thread(target=a.bootstrap, args=(hosts,)) for a in apps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        for _ in range(40):  # gossip until every node shares one checksum
            for a in apps:
                a.ringpop.gossip.tick()
            if len({a.ringpop.membership.checksum for a in apps}) == 1:
                break
        entry = apps[0]
        rows = []
        for sk in keys:
            owner = entry.ringpop.lookup(sk)
            _, body = entry.channel.request(entry.whoami(), "hello", head={"sk": sk}, body=None)
            name = next(a.name for a in apps if a.whoami() == owner)
            rows.append((sk, owner, name, body))
        return hosts, rows
    finally:
        for a in apps:
            a.ringpop.destroy()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="sharded-app", description=__doc__.splitlines()[0])
    p.parse_args(argv)
    hosts, rows = run()
    print("cluster converged:", ", ".join(hosts))
    for sk, owner, _, body in rows:
        print("sk=%-8s owner=%s -> %r" % (sk, owner, body))
    return 0


if __name__ == "__main__":
    sys.exit(main())
