"""Server endpoint layer (server/ rebuilt): every channel endpoint the
framework answers.

Endpoint table mirrors the reference exactly (server/index.js:28-37,
server/protocol/index.js:22-35, server/admin/index.js:24-68):
``/protocol/join|ping|ping-req``, ``/proxy/req``, ``/health``, 13 admin
endpoints, and ``/trace/add|remove``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from ringpop_tpu_torch.gossip.ping_sender import send_ping
from ringpop_tpu_torch.net.channel import RemoteError
from ringpop_tpu_torch.utils import errors
from ringpop_tpu_torch.utils.trace import TraceError, Tracer


def _err(e: errors.RingpopError) -> RemoteError:
    return RemoteError(e.to_dict())


class RingpopServer:
    def __init__(self, ringpop: Any, channel):
        self.ringpop = ringpop
        self.channel = channel
        r = channel.register
        # protocol (server/protocol/index.js:22-35)
        r("/protocol/join", self.protocol_join)
        r("/protocol/ping", self.protocol_ping)
        r("/protocol/ping-req", self.protocol_ping_req)
        # forwarding + health (server/index.js:34-37)
        r("/proxy/req", self.proxy_req)
        r("/health", self.health)
        # admin (server/admin/index.js:24-68; /admin/metrics is this
        # port's addition — Prometheus text next to the JSON stats)
        r("/admin/stats", self.admin_stats)
        r("/admin/metrics", self.admin_metrics)
        r("/admin/lookup", self.admin_lookup)
        r("/admin/reload", self.admin_reload)
        r("/admin/debugSet", self.admin_debug_set)
        r("/admin/debugClear", self.admin_debug_clear)
        r("/admin/gossip", self.admin_gossip_start)  # legacy alias
        r("/admin/gossip/start", self.admin_gossip_start)
        r("/admin/gossip/stop", self.admin_gossip_stop)
        r("/admin/gossip/tick", self.admin_gossip_tick)
        r("/admin/gossip/status", self.admin_gossip_status)
        r("/admin/tick", self.admin_gossip_tick)  # legacy alias
        r("/admin/join", self.admin_member_join)
        r("/admin/leave", self.admin_member_leave)
        r("/admin/member/join", self.admin_member_join)
        r("/admin/member/leave", self.admin_member_leave)
        r("/admin/config/get", self.admin_config_get)
        r("/admin/config/set", self.admin_config_set)
        # trace (server/trace.js)
        r("/trace/add", self.trace_add)
        r("/trace/remove", self.trace_remove)

    # -- protocol ---------------------------------------------------------

    def protocol_join(self, head, body) -> Tuple[Any, Any]:
        """Join validation + full-membership reply
        (server/protocol/join.js:53-135)."""
        ringpop = self.ringpop
        body = body or {}
        app, source = body.get("app"), body.get("source")
        incarnation = body.get("incarnationNumber")
        if app is None or source is None or incarnation is None:
            raise _err(errors.PropertyRequiredError(
                property="app/source/incarnationNumber"))
        if ringpop.joins_denied():
            raise _err(errors.DenyJoinError())
        if source == ringpop.whoami():
            raise _err(errors.InvalidJoinSourceError(actual=source))
        if app != ringpop.app:
            raise _err(errors.InvalidJoinAppError(
                expected=ringpop.app, actual=app))
        for pattern in ringpop.config.get("memberBlacklist") or []:
            if pattern.search(source):
                raise _err(errors.BlacklistedError(member=source))

        ringpop.server_rate.mark()
        ringpop.total_rate.mark()
        ringpop.stat("increment", "join.recv")
        ringpop.membership.make_alive(source, incarnation)
        return None, {
            "app": ringpop.app,
            "coordinator": ringpop.whoami(),
            "membership": ringpop.dissemination.full_sync(),
            "membershipChecksum": ringpop.membership.checksum,
        }

    def protocol_ping(self, head, body) -> Tuple[Any, Any]:
        """Apply piggybacked changes, respond with receiver changes
        (server/protocol/ping.js:24-51)."""
        ringpop = self.ringpop
        body = body or {}
        ringpop.server_rate.mark()
        ringpop.total_rate.mark()
        ringpop.stat("increment", "ping.recv")
        if not ringpop.is_ready:
            raise _err(errors.InvalidLocalMemberError())
        changes = body.get("changes") or []
        if changes:
            ringpop.membership.update(changes)
        res_changes, _ = ringpop.dissemination.issue_as_receiver(
            body.get("source"),
            body.get("sourceIncarnationNumber"),
            body.get("checksum"),
        )
        return None, {"changes": res_changes}

    def protocol_ping_req(self, head, body) -> Tuple[Any, Any]:
        """Ping the target on the requester's behalf
        (server/protocol/ping-req.js:25-69)."""
        ringpop = self.ringpop
        body = body or {}
        ringpop.server_rate.mark()
        ringpop.total_rate.mark()
        ringpop.stat("increment", "ping-req.recv")
        if not ringpop.is_ready:
            raise _err(errors.InvalidLocalMemberError())
        changes = body.get("changes") or []
        if changes:
            ringpop.membership.update(changes)
        target = body.get("target")
        if target is None:
            raise _err(errors.PropertyRequiredError(property="target"))
        ringpop.stat("increment", "ping-req.other-members")
        ok, _ = send_ping(ringpop, {"address": target})
        res_changes, _ = ringpop.dissemination.issue_as_receiver(
            body.get("source"),
            body.get("sourceIncarnationNumber"),
            body.get("checksum"),
        )
        return None, {
            "changes": res_changes,
            "pingStatus": ok,
            "target": target,
        }

    # -- forwarding + health ---------------------------------------------

    def proxy_req(self, head, body) -> Tuple[Any, Any]:
        try:
            res = self.ringpop.request_proxy.handle_request(head or {}, body)
        except errors.RingpopError as e:
            raise _err(e)
        return None, res

    def health(self, head, body) -> Tuple[Any, Any]:
        return None, "ok"

    # -- admin ------------------------------------------------------------

    def admin_stats(self, head, body) -> Tuple[Any, Any]:
        return None, self.ringpop.get_stats()

    def admin_metrics(self, head, body) -> Tuple[Any, Any]:
        """Prometheus text exposition of this node's state (the modern
        collector-facing twin of /admin/stats).  The body is the plain
        exposition string; content-type negotiation is the HTTP
        gateway's concern, not the channel's."""
        from ringpop_tpu_torch.obs.prometheus import render_ringpop_metrics

        return {"contentType": "text/plain; version=0.0.4"}, (
            render_ringpop_metrics(self.ringpop)
        )

    def admin_lookup(self, head, body) -> Tuple[Any, Any]:
        key = (body or {}).get("key")
        if key is None:
            raise _err(errors.LookupKeyRequiredError())
        return None, {"dest": self.ringpop.lookup(key)}

    def admin_reload(self, head, body) -> Tuple[Any, Any]:
        fname = (body or {}).get("file")
        if fname:
            self.ringpop._seed_bootstrap_hosts(fname)
        return None, {"status": "ok"}

    def admin_debug_set(self, head, body) -> Tuple[Any, Any]:
        flag = (body or {}).get("debugFlag")
        if flag:
            self.ringpop.set_debug_flag(flag)
        return None, {"status": "ok"}

    def admin_debug_clear(self, head, body) -> Tuple[Any, Any]:
        self.ringpop.clear_debug_flags()
        return None, {"status": "ok"}

    def admin_gossip_start(self, head, body) -> Tuple[Any, Any]:
        self.ringpop.gossip.start()
        return None, {"status": "ok"}

    def admin_gossip_stop(self, head, body) -> Tuple[Any, Any]:
        self.ringpop.gossip.stop()
        return None, {"status": "ok"}

    def admin_gossip_tick(self, head, body) -> Tuple[Any, Any]:
        self.ringpop.gossip.tick()
        return None, {"checksum": self.ringpop.membership.checksum}

    def admin_gossip_status(self, head, body) -> Tuple[Any, Any]:
        return None, {"status": "stopped" if self.ringpop.gossip.is_stopped else "running"}

    def admin_member_join(self, head, body) -> Tuple[Any, Any]:
        """Rejoin a left node (server/admin/member.js:44-51)."""
        ringpop = self.ringpop
        local = ringpop.membership.local_member
        if local is None:
            raise _err(errors.InvalidLocalMemberError())
        ringpop.membership.make_alive(local.address, ringpop.timers.now_ms())
        ringpop.gossip.start()
        ringpop.suspicion.reenable()
        return None, {"status": "rejoined"}

    def admin_member_leave(self, head, body) -> Tuple[Any, Any]:
        """Graceful leave (server/admin/member.js, §3.5)."""
        ringpop = self.ringpop
        local = ringpop.membership.local_member
        if local is None:
            raise _err(errors.InvalidLocalMemberError())
        if local.status == "leave":
            raise _err(errors.RedundantLeaveError())
        ringpop.membership.make_leave(
            local.address, local.incarnation_number
        )
        return None, {"status": "ok"}

    def admin_config_get(self, head, body) -> Tuple[Any, Any]:
        return None, self.ringpop.config.get_all()

    def admin_config_set(self, head, body) -> Tuple[Any, Any]:
        for key, value in (body or {}).items():
            self.ringpop.config.set(key, value)
        return None, {"status": "ok"}

    # -- trace ------------------------------------------------------------

    def trace_add(self, head, body) -> Tuple[Any, Any]:
        body = body or {}
        try:
            tracer = Tracer(
                self.ringpop,
                body.get("event"),
                body.get("sink") or {},
                body.get("expiresIn"),
            )
        except TraceError as e:
            raise RemoteError({"type": "ringpop.trace.invalid", "message": str(e)})
        self.ringpop.tracers.add(tracer)
        return None, {"status": "ok"}

    def trace_remove(self, head, body) -> Tuple[Any, Any]:
        body = body or {}
        removed = self.ringpop.tracers.remove(
            body.get("event"), body.get("sink") or {}
        )
        return None, {"status": "ok" if removed else "not-found"}
