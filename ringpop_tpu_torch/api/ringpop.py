"""The Ringpop facade — the framework's public API (index.js rebuilt).

Composes every component (membership, ring, gossip, dissemination,
suspicion, request proxy, rollup, tracers, server endpoints) and wires the
event plumbing between them, mirroring the reference's constructor
(index.js:70-175) and the three event-wiring modules
(lib/on_membership_event.js, on_ring_event.js, on_ringpop_event.js).

Intended surface (index.js:27-30): ``bootstrap()``, ``lookup()``,
``whoami()`` — plus ``lookup_n``, ``handle_or_proxy(_all)``, ``proxy_req``,
``get_stats``, ``register_stats_hook``, ``setup_channel``, ``destroy`` and
the EventEmitter events (``ready``, ``membershipChanged``, ``ringChanged``,
``request``, ``lookup``).

The port's copy of ``ringpop_tpu/api/ringpop.py``: host code (sockets,
threads, the host object model and the C++ FarmHash), no tensor.
"""

from __future__ import annotations

import json
import os
import random
import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import ringpop_tpu_torch
from ringpop_tpu_torch.gossip.dissemination import Dissemination
from ringpop_tpu_torch.gossip.gossip import Gossip
from ringpop_tpu_torch.gossip.join_sender import JoinError, join_cluster
from ringpop_tpu_torch.gossip.suspicion import Suspicion
from ringpop_tpu_torch.models.membership.host import (
    Membership,
    MembershipIterator,
    Status,
)
from ringpop_tpu_torch.models.ring.host import HashRing
from ringpop_tpu_torch.net.channel import Channel
from ringpop_tpu_torch.net.timers import Timers
from ringpop_tpu_torch.utils.config import Config, EventEmitter
from ringpop_tpu_torch.utils import errors
from ringpop_tpu_torch.utils.rollup import MembershipUpdateRollup
from ringpop_tpu_torch.utils.stats import Meter, NullLogger, NullStatsd
from ringpop_tpu_torch.utils.trace import TracerStore
from ringpop_tpu_torch.utils.util import HOST_PORT_PATTERN

MEMBERSHIP_UPDATE_FLUSH_INTERVAL_MS = 5000  # index.js:68


class RingpopError(Exception):
    pass


class Ringpop(EventEmitter):
    def __init__(
        self,
        app: str,
        host_port: str,
        channel: Optional[Channel] = None,
        logger: Any = None,
        statsd: Any = None,
        options: Optional[Dict[str, Any]] = None,
        timers: Optional[Timers] = None,
        seed: Optional[int] = None,
    ):
        super().__init__()
        options = dict(options or {})
        if not app or not isinstance(app, str):
            raise errors.AppRequiredError()
        if (
            not isinstance(host_port, str)
            or not HOST_PORT_PATTERN.match(host_port)
        ):
            raise errors.HostPortRequiredError(hostPort=host_port, reason='a valid host:port')

        self.app = app
        self.host_port = host_port
        self.logger = logger or NullLogger()
        self.statsd = statsd or NullStatsd()
        self.timers = timers or Timers()
        # Date.now() analog riding the timer plane, so fake-timer tests see
        # one coherent clock (Member reads it for damp-score decay deltas)
        self.now = self.timers.now_ms
        self.rng = random.Random(seed)
        self.destroyed = False
        self.is_ready = False
        self.joining = False
        self.bootstrap_hosts: Optional[List[str]] = None
        self._joins_denied = False
        self.debug_flags: Dict[str, bool] = {}
        self.start_time: Optional[float] = None

        # protocol knobs (index.js:112-120)
        self.ping_req_size = options.get("pingReqSize", 3)
        self.ping_req_timeout_ms = options.get("pingReqTimeout", 5000)
        self.ping_timeout_ms = options.get("pingTimeout", 1500)
        self.join_size = options.get("joinSize", 3)
        self.join_timeout_ms = options.get("joinTimeout", 1000)
        self.max_join_duration_ms = options.get("maxJoinDuration", 120000)
        self.proxy_req_timeout_ms = options.get("proxyReqTimeout", 30000)
        self.min_protocol_period_ms = options.get("minProtocolPeriod", 200)
        self.suspicion_timeout_ms = options.get("suspicionTimeout", 5000)

        # stats identity: ringpop.<host_port with non-alnum -> '_'>
        # (index.js:162-164)
        self.stat_host_port = re.sub(r"[.:]", "_", host_port)
        self.stat_prefix = "ringpop.%s" % self.stat_host_port
        self.stat_keys: Dict[str, str] = {}
        self.stats_hooks: Dict[str, Any] = {}

        # components (index.js:124-156)
        self.config = Config(self, options)
        self.membership = Membership(self, rng=self.rng)
        self.member_iterator = MembershipIterator(self)
        self.ring = HashRing()
        self.dissemination = Dissemination(self)
        self.suspicion = Suspicion(self, self.suspicion_timeout_ms)
        self.gossip = Gossip(self, self.min_protocol_period_ms, rng=self.rng)
        self.membership_update_rollup = MembershipUpdateRollup(
            self, MEMBERSHIP_UPDATE_FLUSH_INTERVAL_MS
        )
        self.tracers = TracerStore(self)

        from ringpop_tpu_torch.api.request_proxy import RequestProxy

        self.request_proxy = RequestProxy(self, options.get("requestProxy") or {})

        # request-rate meters (index.js:158-160)
        self.client_rate = Meter()
        self.server_rate = Meter()
        self.total_rate = Meter()

        self.channel = channel
        self.server = None
        if channel is not None:
            self.setup_channel()

        self._wire_events()
        # "It would be more correct to start Membership's background
        # decayer once we know that a member has been penalized for a
        # flap. But it's OK to start prematurely."
        # (lib/membership/index.js:399-407)
        self.membership.start_damp_score_decayer()

    # -- event plumbing (lib/on_membership_event.js etc.) ----------------

    def _wire_events(self) -> None:
        self.membership.on("updated", self._on_membership_updated)
        self.membership.on("set", self._on_membership_set)
        self.membership.on("event", self._on_membership_event)
        # flap-damping signals (membership/index.js:406,415-417 — the
        # reference's onExceeded is a TODO'd subprotocol hook; stats +
        # facade events carry the signal here, recovery included)
        self.membership.on(
            "memberSuppressLimitExceeded", self._on_member_suppressed
        )
        self.membership.on(
            "memberSuppressRecovered", self._on_member_suppress_recovered
        )
        self.ring.on("added", self._on_ring_server_added)
        self.ring.on("removed", self._on_ring_server_removed)
        self.ring.on(
            "checksumComputed",
            lambda *a: self.stat("increment", "ring.checksum-computed"),
        )
        self.on("ready", self._on_ready)

    def _on_member_suppressed(self, member) -> None:
        self.stat("increment", "damp-score.suppress-limit-exceeded")
        self.emit("memberSuppressLimitExceeded", member)

    def _on_member_suppress_recovered(self, member, score) -> None:
        self.stat("increment", "damp-score.suppress-recovered")
        self.emit("memberSuppressRecovered", member, score)

    def _on_ready(self) -> None:
        self.start_time = time.time()
        if self.config.get("autoGossip"):
            self.gossip.start()

    def _on_membership_event(self, event: Dict[str, Any]) -> None:
        # LocalMemberLeaveEvent -> stop gossiping (on_membership_event.js:32-41)
        if event.get("name") == "LocalMemberLeaveEvent":
            self.gossip.stop()
            self.suspicion.stop_all()

    def _on_membership_set(self, updates) -> None:
        # on_membership_event.js:42-68
        servers_to_add = []
        for update in updates:
            d = update.to_dict() if hasattr(update, "to_dict") else dict(update)
            status = d.get("status")
            if status == Status.suspect:
                self.suspicion.start(d)
            if status in (Status.alive, Status.suspect):
                servers_to_add.append(d["address"])
            self.dissemination.record_change(d)
            self.stat("increment", "membership-set.%s" % (status or "unknown"))
        self.ring.add_remove_servers(servers_to_add, [])
        self.emit("membershipChanged")
        self.emit("changed")  # deprecated alias (index.js)

    def _on_membership_updated(self, updates) -> None:
        # on_membership_event.js:70-144 — three responsibilities:
        # stats/rollup, suspicion + dissemination, ring add/remove.
        servers_to_add: List[str] = []
        servers_to_remove: List[str] = []
        for update in updates:
            d = update.to_dict() if hasattr(update, "to_dict") else dict(update)
            status = d.get("status")
            address = d["address"]
            if status == Status.alive:
                self.suspicion.stop(d)
                servers_to_add.append(address)
            elif status == Status.suspect:
                self.suspicion.start(d)
                servers_to_add.append(address)
            elif status == Status.faulty:
                self.suspicion.stop(d)
                servers_to_remove.append(address)
            elif status == Status.leave:
                self.suspicion.stop(d)
                servers_to_remove.append(address)
            self.dissemination.record_change(d)
            self.stat("increment", "membership-update.%s" % (status or "unknown"))
        self.membership_update_rollup.track_updates(updates)
        self.stat("gauge", "num-members", self.membership.get_member_count())
        self.stat("timing", "updates", len(updates))
        self.ring.add_remove_servers(servers_to_add, servers_to_remove)
        self.emit("membershipChanged")
        self.emit("changed")

    def _on_ring_server_added(self, *a) -> None:
        self.stat("increment", "ring.server-added")
        self.dissemination.adjust_max_piggyback_count()
        self.emit("ringServerAdded")
        self.emit("ringChanged")

    def _on_ring_server_removed(self, *a) -> None:
        self.stat("increment", "ring.server-removed")
        self.dissemination.adjust_max_piggyback_count()
        self.emit("ringServerRemoved")
        self.emit("ringChanged")

    # -- identity ---------------------------------------------------------

    def whoami(self) -> str:
        return self.host_port

    # -- channel / server -------------------------------------------------

    def setup_channel(self) -> None:
        from ringpop_tpu_torch.api.server import RingpopServer

        if self.channel is None:
            self.channel = Channel(self.host_port)
        self.server = RingpopServer(self, self.channel)

    # -- bootstrap --------------------------------------------------------

    def _seed_bootstrap_hosts(self, bootstrap_file) -> None:
        # index.js:483-511: array, file path, or JSON string
        if isinstance(bootstrap_file, (list, tuple)):
            self.bootstrap_hosts = list(bootstrap_file)
        elif isinstance(bootstrap_file, str) and os.path.exists(bootstrap_file):
            with open(bootstrap_file) as f:
                self.bootstrap_hosts = json.load(f)
        elif isinstance(bootstrap_file, str):
            try:
                self.bootstrap_hosts = json.loads(bootstrap_file)
            except ValueError:
                raise errors.ArgumentRequiredError(argument='bootstrapFile (readable hosts)')
        else:
            self.bootstrap_hosts = None

    def bootstrap(
        self,
        bootstrap_file_or_opts: Union[None, str, List[str], Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Make the local member alive, join the cluster, apply the merged
        membership atomically, and start gossip (index.js:235-378)."""
        opts: Dict[str, Any] = {}
        if isinstance(bootstrap_file_or_opts, dict):
            opts = dict(bootstrap_file_or_opts)
            bootstrap_file = opts.pop("bootstrapFile", None)
        else:
            bootstrap_file = bootstrap_file_or_opts

        if self.is_ready:
            self.logger.warning(
                "ringpop is already ready", extra={"local": self.whoami()}
            )
            return {"alreadyReady": True}
        if self.channel is None or self.channel.host_port is None:
            raise RingpopError(
                "Channel must be listening before bootstrap"
            )

        self._seed_bootstrap_hosts(bootstrap_file)
        if not self.bootstrap_hosts:
            self.bootstrap_hosts = [self.whoami()]
        if self.whoami() not in self.bootstrap_hosts:
            self.logger.warning(
                "local node missing from bootstrap hosts",
                extra={"local": self.whoami()},
            )

        bootstrap_time = time.time()
        self.membership.make_alive(self.whoami(), self.timers.now_ms())

        others = [h for h in self.bootstrap_hosts if h != self.whoami()]
        nodes_joined: List[str] = []
        if others:
            self.joining = True
            try:
                result = join_cluster(
                    self,
                    {
                        "joinSize": min(self.join_size, len(others)),
                        "joinTimeout": self.join_timeout_ms,
                        "maxJoinDuration": opts.get(
                            "maxJoinDuration", self.max_join_duration_ms
                        ),
                    },
                )
                nodes_joined = result["nodesJoined"]
            finally:
                self.joining = False

        self.membership.set()
        self.is_ready = True
        self.stat("timing", "bootstrap", bootstrap_time)
        self.stat("increment", "bootstrap-complete")
        self.emit("ready")
        return {"bootstrapTime": time.time() - bootstrap_time,
                "nodesJoined": nodes_joined}

    # -- lookup & routing -------------------------------------------------

    def lookup(self, key) -> Optional[str]:
        start = time.time()
        dest = self.ring.lookup(str(key))
        self.stat("timing", "lookup", start)
        self.emit("lookup", {"timing": time.time() - start})
        if dest is None:
            self.logger.warning(
                "could not find destination for key",
                extra={"local": self.whoami(), "key": key},
            )
            return self.whoami()
        return dest

    def lookup_n(self, key, n: int) -> List[str]:
        start = time.time()
        dests = self.ring.lookup_n(str(key), n)
        self.stat("timing", "lookupn", start)
        self.emit("lookup", {"timing": time.time() - start})
        if not dests:
            self.logger.warning(
                "could not find destinations for key",
                extra={"local": self.whoami(), "key": key},
            )
            return [self.whoami()]
        return dests

    def handle_or_proxy(self, key, req, res=None, opts: Optional[dict] = None) -> bool:
        """True -> the caller owns the key and should handle the request;
        False -> the request was proxied to its owner (index.js:580-607)."""
        dest = self.lookup(key)
        if dest == self.whoami():
            return True
        proxy_opts = dict(opts or {})
        proxy_opts.update(keys=[str(key)], dest=dest, req=req, res=res)
        self.proxy_req(proxy_opts)
        return False

    def handle_or_proxy_all(self, keys: Sequence[Any], req, handler=None) -> List[dict]:
        """Group keys by owner; handle local groups via ``handler`` (or the
        'request' event), proxy remote groups (index.js:609-667).
        Returns [{dest, keys, res|error}]."""
        whoami = self.whoami()
        groups: Dict[str, List[str]] = {}
        for key in keys:
            groups.setdefault(self.lookup(key), []).append(str(key))

        out = []
        for dest, dest_keys in groups.items():
            entry: Dict[str, Any] = {"dest": dest, "keys": dest_keys}
            try:
                if dest == whoami:
                    if handler is not None:
                        entry["res"] = handler(dest_keys, req)
                    else:
                        from ringpop_tpu_torch.api.request_proxy import LocalResponse

                        res = LocalResponse()
                        self.emit("request", dict(req or {}, ringpopKeys=dest_keys), res, {})
                        entry["res"] = res.wait(self.proxy_req_timeout_ms / 1000.0)
                else:
                    entry["res"] = self.request_proxy.proxy_req(
                        {"keys": dest_keys, "dest": dest, "req": req}
                    )
            except Exception as e:
                entry["error"] = e
            out.append(entry)
        return out

    def proxy_req(self, opts: Dict[str, Any]):
        if not opts or not opts.get("keys") or not opts.get("dest"):
            raise errors.PropertyRequiredError(property='keys/dest')
        return self.request_proxy.proxy_req(opts)

    # -- stats ------------------------------------------------------------

    def stat(self, stat_type: str, key: str, value: Any = None) -> None:
        """statsd emission with per-key fq-name cache (index.js:527-541)."""
        fq_key = self.stat_keys.get(key)
        if fq_key is None:
            fq_key = "%s.%s" % (self.stat_prefix, key)
            self.stat_keys[key] = fq_key
        if stat_type == "increment":
            self.statsd.increment(fq_key, value if value is not None else 1)
        elif stat_type == "gauge":
            self.statsd.gauge(fq_key, value)
        elif stat_type == "timing":
            # accept either a start timestamp (seconds) or a duration
            if isinstance(value, float) and value > 1e9:
                value = (time.time() - value) * 1000.0
            self.statsd.timing(fq_key, value)

    def register_stats_hook(self, hook: Dict[str, Any]) -> None:
        """index.js:560-578: {name, fetch()} contributes to getStats()."""
        if not hook or "name" not in hook:
            raise errors.PropertyRequiredError(property='name')
        if not callable(hook.get("fetch")):
            raise errors.PropertyRequiredError(property='fetch (callable)')
        if hook["name"] in self.stats_hooks:
            raise errors.DuplicateHookError(name=hook['name'])
        self.stats_hooks[hook["name"]] = hook

    def get_stats(self) -> Dict[str, Any]:
        hooks_stats = {
            name: hook["fetch"]() for name, hook in self.stats_hooks.items()
        }
        uptime = time.time() - self.start_time if self.start_time else 0
        return {
            "hooks": hooks_stats or None,
            "membership": self.membership.get_stats(),
            "process": {"pid": os.getpid()},
            "protocol": self.gossip.get_stats(),
            "ring": sorted(self.ring.servers),
            "version": ringpop_tpu_torch.__version__,
            "timestamp": int(time.time() * 1000),
            "uptime": uptime,
        }

    # -- debug flags (index.js:513-521) -----------------------------------

    def set_debug_flag(self, flag: str) -> None:
        self.debug_flags[flag] = True

    def clear_debug_flags(self) -> None:
        self.debug_flags = {}

    def debug_flag_enabled(self, flag: str) -> bool:
        return bool(self.debug_flags.get(flag))

    # -- join denial test hook (index.js:670-677) -------------------------

    def deny_joins(self) -> None:
        self._joins_denied = True

    def allow_joins(self) -> None:
        self._joins_denied = False

    def joins_denied(self) -> bool:
        return self._joins_denied

    # -- teardown ---------------------------------------------------------

    def destroy(self) -> None:
        if self.destroyed:
            return
        self.emit("destroying")
        self.gossip.stop()
        self.suspicion.stop_all()
        self.membership.stop_damp_score_decayer()
        self.membership_update_rollup.destroy()
        self.tracers.destroy()
        self.request_proxy.destroy()
        if self.channel is not None:
            self.channel.destroy()
        self.destroyed = True
        self.emit("destroyed")
