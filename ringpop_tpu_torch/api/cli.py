"""Standalone node CLI (main.js:24-85 rebuilt).

``python -m ringpop_tpu_torch.api.cli --listen 127.0.0.1:3000 --hosts hosts.json``
starts one Ringpop node: open the channel, bootstrap against the hosts
file, gossip until terminated.  Mirrors the reference ``ringpop`` bin:
``--listen/-l`` and ``--hosts/-h`` are both required (main.js:29-37 prints
usage and exits otherwise).

The port's copy of ``ringpop_tpu/api/cli.py``.  The node is host-side
control plane by the protocol's nature (sockets, SWIM objects, the C++
hash oracle): it allocates no tensor and touches no card.  Its wire
format is the JAX node's, so nodes of both packages join one cluster.
"""


from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading

from ringpop_tpu_torch.api.ringpop import Ringpop
from ringpop_tpu_torch.net.channel import Channel


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ringpop-tpu",
        description="Start a ringpop-tpu node (reference: main.js)",
    )
    p.add_argument(
        "--listen",
        "-l",
        metavar="HOST:PORT",
        help="host and port on which the node listens",
    )
    p.add_argument(
        "--hosts",
        "-H",
        metavar="FILE|JSON",
        help="bootstrap hosts: a hosts.json path or a JSON array",
    )
    p.add_argument("--app", default="ringpop", help="app name (cluster id)")
    p.add_argument(
        "--quiet", action="store_true", help="suppress the console logger"
    )
    return p


def main(argv=None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    # main.js:29-37: both required, usage printed otherwise
    if not args.listen or not args.hosts:
        parser.print_usage(sys.stderr)
        return 1

    logger = None
    if not args.quiet:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(message)s",
            stream=sys.stderr,
        )
        logger = logging.getLogger("ringpop-tpu")

    done = threading.Event()

    def on_signal(signum, frame):
        done.set()

    # handlers installed before the 'ready' line: a supervisor may signal
    # the instant it reads it
    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    channel = Channel(args.listen)
    host_port = channel.listen()
    ringpop = Ringpop(args.app, host_port, channel=channel, logger=logger)
    ringpop.bootstrap(args.hosts)
    print(json.dumps({"listening": host_port, "ready": True}), flush=True)
    done.wait()
    ringpop.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
