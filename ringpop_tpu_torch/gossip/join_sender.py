"""Cluster bootstrap join (lib/gossip/join-sender.js rebuilt).

Joins ``joinSize`` (3) cluster members before declaring bootstrap complete:
each round selects ``(joinSize - joined) * parallelismFactor`` targets —
preferring nodes on *other* hosts (join-sender.js:160-178,445-483) — sends
``/protocol/join`` concurrently, and retries with a delay until joinSize is
met, ``maxJoinAttempts`` (50) rounds pass, or ``maxJoinDuration`` (5 min)
elapses (join-sender.js:51-66,194-327).  All join responses are aggregated
and merged into membership once at the end (join-sender.js:250-259).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

from ringpop_tpu_torch.gossip.join_response_merge import merge_join_responses
from ringpop_tpu_torch.net.channel import ChannelError, RemoteError
from ringpop_tpu_torch.utils.util import capture_host

JOIN_SIZE = 3  # join-sender.js:52
JOIN_TIMEOUT_MS = 1000  # join-sender.js:56
JOIN_RETRY_DELAY_MS = 100  # join-sender.js:61
MAX_JOIN_DURATION_MS = 120000  # join-sender.js:64
PARALLELISM_FACTOR = 2  # join-sender.js:66


class JoinError(Exception):
    def __init__(self, message: str, type_: str):
        super().__init__(message)
        self.type = type_


class JoinCluster:
    def __init__(self, ringpop: Any, opts: Optional[Dict[str, Any]] = None):
        opts = opts or {}
        self.ringpop = ringpop
        self.host = capture_host(ringpop.whoami())
        self.join_size = opts.get("joinSize", JOIN_SIZE)
        self.join_timeout_ms = opts.get("joinTimeout", JOIN_TIMEOUT_MS)
        self.join_retry_delay_ms = opts.get("joinRetryDelay", JOIN_RETRY_DELAY_MS)
        self.max_join_duration_ms = opts.get("maxJoinDuration", MAX_JOIN_DURATION_MS)
        self.parallelism_factor = opts.get("parallelismFactor", PARALLELISM_FACTOR)
        self.potential_nodes = self._init_potential(ringpop.bootstrap_hosts or [])
        self.preferred_nodes: List[str] = []
        self.non_preferred_nodes: List[str] = []
        self.rng = getattr(ringpop, "rng", None) or random.Random()

    def _init_potential(self, hosts: List[str]) -> List[str]:
        return [h for h in hosts if h != self.ringpop.whoami()]

    def _select_group(self, num: int) -> List[str]:
        """Prefer nodes on other hosts (join-sender.js:445-483)."""
        self.preferred_nodes = [
            n for n in self.potential_nodes if capture_host(n) != self.host
        ]
        self.non_preferred_nodes = [
            n for n in self.potential_nodes if capture_host(n) == self.host
        ]
        pool = list(self.preferred_nodes)
        self.rng.shuffle(pool)
        group = pool[:num]
        if len(group) < num:
            rest = list(self.non_preferred_nodes)
            self.rng.shuffle(rest)
            group += rest[: num - len(group)]
        return group

    def _join_node(self, node: str):
        body = {
            "app": self.ringpop.app,
            "source": self.ringpop.whoami(),
            "incarnationNumber": self.ringpop.membership.get_incarnation_number(),
            "timeout": self.join_timeout_ms,
        }
        _, res = self.ringpop.channel.request(
            node,
            "/protocol/join",
            head=None,
            body=body,
            timeout_s=self.join_timeout_ms / 1000.0,
        )
        return res

    def join(self) -> Dict[str, Any]:
        """Blocking join; returns {nodesJoined, membership merged}."""
        if self.ringpop.destroyed:
            raise JoinError(
                "joiner was destroyed before joining cluster",
                "ringpop-tpu.joiner-destroyed",
            )
        if not self.potential_nodes:
            # single-node cluster (bootstrap handles this upstream too)
            return {"nodesJoined": []}

        start = time.time() * 1000.0
        nodes_joined: List[str] = []
        join_responses: List[Dict[str, Any]] = []
        failures: List[Dict[str, Any]] = []
        num_failed = 0
        num_groups = 0
        # like the reference, maxJoinAttempts bounds FAILED NODE attempts,
        # not retry rounds (join-sender.js:275-289 `numFailed >=
        # maxJoinAttempts`)
        max_attempts = self.ringpop.config.get("maxJoinAttempts")

        while len(nodes_joined) < self.join_size:
            if self.ringpop.destroyed:
                raise JoinError(
                    "joiner was destroyed while joining cluster",
                    "ringpop-tpu.joiner-destroyed",
                )
            elapsed = time.time() * 1000.0 - start
            if elapsed > self.max_join_duration_ms:
                self.ringpop.logger.warning(
                    "ringpop join duration exceeded",
                    extra={
                        "local": self.ringpop.whoami(),
                        "joinDuration": elapsed,
                        "maxJoinDuration": self.max_join_duration_ms,
                        "numJoined": len(nodes_joined),
                        "numFailed": num_failed,
                    },
                )
                raise JoinError(
                    "join duration exceeded", "ringpop-tpu.join-duration-exceeded"
                )
            if num_failed >= max_attempts:
                self.ringpop.logger.warning(
                    "ringpop max join attempts exceeded",
                    extra={
                        "local": self.ringpop.whoami(),
                        "joinAttempts": num_failed,
                        "maxJoinAttempts": max_attempts,
                        "numJoined": len(nodes_joined),
                        "failures": failures[-5:],
                    },
                )
                raise JoinError(
                    "max join attempts exceeded", "ringpop-tpu.join-attempts-exceeded"
                )

            remaining = [n for n in self.potential_nodes if n not in nodes_joined]
            if not remaining:
                break
            want = (self.join_size - len(nodes_joined)) * self.parallelism_factor
            self.potential_nodes = remaining
            group = self._select_group(want)
            if not group:
                break
            num_groups += 1

            results: List[Optional[Dict[str, Any]]] = [None] * len(group)
            errors_seen: List[Optional[Exception]] = [None] * len(group)

            def attempt(i: int, node: str) -> None:
                try:
                    results[i] = self._join_node(node)
                except (ChannelError, RemoteError) as e:
                    errors_seen[i] = e

            threads = [
                threading.Thread(target=attempt, args=(i, n), daemon=True)
                for i, n in enumerate(group)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(self.join_timeout_ms / 1000.0 + 1.0)

            for i, (node, res) in enumerate(zip(group, results)):
                if res is None:
                    # triage: transport failure vs application rejection
                    # (join-sender.js:233-283 error paths)
                    err = errors_seen[i]
                    if isinstance(err, RemoteError):
                        payload = err.payload
                        err_type = (
                            payload.get("type", "remote")
                            if isinstance(payload, dict)
                            else "remote"
                        )
                    elif isinstance(err, ChannelError):
                        err_type = err.type
                    else:
                        err_type = "timeout"
                    failures.append({"node": node, "errType": err_type})
                    num_failed += 1
                    self.ringpop.stat("increment", "join.failed")
                    continue
                if len(nodes_joined) >= self.join_size:
                    continue
                nodes_joined.append(node)
                join_responses.append(
                    {
                        "checksum": res.get("membershipChecksum"),
                        "members": res.get("membership") or [],
                    }
                )

            if len(nodes_joined) < self.join_size:
                candidates_left = [
                    n for n in self.potential_nodes if n not in nodes_joined
                ]
                if not candidates_left:
                    break
                self.ringpop.timers.sleep(self.join_retry_delay_ms / 1000.0)

        if not nodes_joined:
            raise JoinError("no nodes joined", "ringpop-tpu.join-failed")

        join_time_ms = time.time() * 1000.0 - start
        updates = merge_join_responses(self.ringpop, join_responses)
        self.ringpop.membership.update(updates)
        self.ringpop.stat("timing", "join", join_time_ms)
        self.ringpop.stat("increment", "join.complete")
        self.ringpop.logger.debug(
            "ringpop join complete",
            extra={
                "local": self.ringpop.whoami(),
                "joinSize": self.join_size,
                "joinTime": join_time_ms,
                "numJoined": len(nodes_joined),
                "numGroups": num_groups,
                "numFailed": num_failed,
            },
        )
        return {
            "nodesJoined": nodes_joined,
            "numJoined": len(nodes_joined),
            "numFailed": num_failed,
            "numGroups": num_groups,
            "failures": failures,
            "joinTime": join_time_ms,
        }


def join_cluster(ringpop: Any, opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    return JoinCluster(ringpop, opts).join()
