"""Request forwarding (lib/request-proxy/ rebuilt).

Client side: serialize a request's routing envelope — url, method, headers,
keys, and the local membership checksum — and send it to the key's owner
over ``/proxy/req`` (lib/request-proxy/send.js:230-307, util.js:22-35).
Failures retry on the reference's schedule (0 s, 1 s, 3.5 s,
send.js:49) after **re-looking-up the keys**: if the ring moved, the retry
reroutes to the new owner (send.js:181-208); if the keys now map to more
than one owner, the retry aborts with a keys-diverged error
(send.js:91-104); if the new owner is the local node, the request is
handled in-process (send.js:190-198).

Server side: rebuild the request, reject on membership-checksum mismatch
when ``enforceConsistency`` (lib/request-proxy/index.js:168-229), and emit
``request`` to the application.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ringpop_tpu_torch.net.channel import ChannelError, RemoteError
from ringpop_tpu_torch.utils import errors

RETRY_SCHEDULE_S = [0.0, 1.0, 3.5]  # send.js:49
DEFAULT_MAX_RETRIES = 3


class LocalResponse:
    """Response collector handed to 'request' handlers: call ``end(body)``
    (optionally ``status``) exactly once."""

    def __init__(self):
        self._event = threading.Event()
        self.status = 200
        self.body = None
        self.headers: Dict[str, Any] = {}

    def end(self, body: Any = None, status: int = 200, headers=None) -> None:
        self.body = body
        self.status = status
        if headers:
            self.headers = dict(headers)
        self._event.set()

    def wait(self, timeout_s: float):
        if not self._event.wait(timeout_s):
            raise ChannelError("request handler timed out", "ringpop-tpu.timeout")
        return {"statusCode": self.status, "headers": self.headers, "body": self.body}


class RequestProxy:
    def __init__(self, ringpop: Any, opts: Optional[Dict[str, Any]] = None):
        opts = opts or {}
        self.ringpop = ringpop
        self.retry_schedule_s = opts.get("retrySchedule", RETRY_SCHEDULE_S)
        self.max_retries = opts.get("maxRetries", DEFAULT_MAX_RETRIES)
        self.enforce_consistency = opts.get("enforceConsistency", True)
        # buffered-body cap forwarded to every send, overridable per
        # request (lib/request-proxy/index.js:88-90); None = unlimited
        self.body_limit = opts.get("bodyLimit")
        self.destroyed = False

    @staticmethod
    def _body_length(body: Any) -> int:
        """Byte length of the body as it will ride the wire — the analog
        of the reference buffering the raw request stream."""
        if body is None:
            return 0
        if isinstance(body, (bytes, bytearray)):
            return len(body)
        import json

        # everything else rides the channel as its JSON encoding
        return len(json.dumps(body).encode("utf-8"))

    def _check_body_limit(self, body: Any, limit: Optional[int]) -> None:
        if limit is None:
            return
        length = self._body_length(body)
        if length > limit:
            # reference: body-module limit error -> logger.warn
            # 'requestProxy encountered malformed body' -> sendError(res)
            # (lib/request-proxy/index.js:93-100)
            self.ringpop.logger.warning(
                "requestProxy encountered malformed body",
                extra={"limit": limit, "length": length},
            )
            raise errors.BodyLimitExceededError(limit=limit, length=length)

    # -- client side ------------------------------------------------------

    def proxy_req(self, opts: Dict[str, Any]) -> Dict[str, Any]:
        """opts: {keys, dest, req: {url, method, headers, body}, timeout?,
        maxRetries?, endpoint?}.  Returns the remote response dict."""
        if self.destroyed:
            raise errors.RequestProxyDestroyedError()
        keys: List[str] = list(opts["keys"])
        dest: str = opts["dest"]
        req = dict(opts.get("req") or {})
        timeout_s = (opts.get("timeout") or self.ringpop.proxy_req_timeout_ms) / 1000.0
        max_retries = opts.get("maxRetries", self.max_retries)
        endpoint = opts.get("endpoint", "/proxy/req")
        self._check_body_limit(
            req.get("body"), opts.get("bodyLimit", self.body_limit)
        )

        self.ringpop.stat("increment", "requestProxy.requests.outgoing")
        attempt = 0
        while True:
            if self.destroyed or getattr(
                self.ringpop.channel, "destroyed", False
            ):
                # the reference re-checks before every forwarding attempt —
                # a proxy OR channel destroyed mid-retry aborts the
                # in-flight send rather than burning the retry schedule
                # against a dead channel ('Channel was destroyed before
                # forwarding attempt', send.js:228-234,
                # test/integration/proxy-test.js:1039-1063)
                raise errors.RequestProxyDestroyedError()
            head = {
                "url": req.get("url"),
                "method": req.get("method", "GET"),
                "headers": req.get("headers") or {},
                "httpVersion": req.get("httpVersion", "1.1"),
                "ringpopChecksum": self.ringpop.membership.checksum,
                "ringpopKeys": keys,
            }
            try:
                _, res = self.ringpop.channel.request(
                    dest, endpoint, head=head, body=req.get("body"),
                    timeout_s=timeout_s,
                )
                if attempt > 0:
                    # a RETRY landed (send.js:160-166)
                    self.ringpop.stat(
                        "increment", "requestProxy.retry.succeeded"
                    )
                self.ringpop.stat("increment", "requestProxy.send.success")
                return res
            except (ChannelError, RemoteError) as e:
                if isinstance(e, RemoteError):
                    payload = e.payload or {}
                    # checksum mismatches are retryable (ring may converge);
                    # other application errors are not
                    if payload.get("type") != errors.InvalidCheckSumError.type:
                        self.ringpop.stat(
                            "increment", "requestProxy.send.error"
                        )
                        raise
                if attempt >= max_retries:
                    self.ringpop.stat(
                        "increment", "requestProxy.retry.failed"
                    )
                    self.ringpop.stat("increment", "requestProxy.send.error")
                    raise errors.MaxRetriesExceededError(maxRetries=max_retries)
                delay = self.retry_schedule_s[
                    min(attempt, len(self.retry_schedule_s) - 1)
                ]
                self.ringpop.stat("increment", "requestProxy.retry.attempted")
                self.ringpop.timers.sleep(delay)
                attempt += 1
                dest = self._relookup(keys, dest)
                if dest == self.ringpop.whoami():
                    # reroute local (send.js:190-198) — a landed retry and
                    # a completed request, so the full success accounting
                    # fires like the remote path's
                    self.ringpop.stat(
                        "increment", "requestProxy.retry.reroute.local"
                    )
                    try:
                        out = self._handle_locally(head, req.get("body"))
                    except Exception:
                        # keep the accounting closed like the remote
                        # handler-error path does
                        self.ringpop.stat(
                            "increment", "requestProxy.send.error"
                        )
                        raise
                    self.ringpop.stat(
                        "increment", "requestProxy.retry.succeeded"
                    )
                    self.ringpop.stat(
                        "increment", "requestProxy.send.success"
                    )
                    return out
                self.ringpop.stat(
                    "increment", "requestProxy.retry.reroute.remote"
                )

    def _relookup(self, keys: List[str], orig_dest: str) -> str:
        dests = {self.ringpop.lookup(k) for k in keys}
        if len(dests) > 1:
            self.ringpop.stat("increment", "requestProxy.retry.aborted")
            # the request fails permanently here: close the accounting
            self.ringpop.stat("increment", "requestProxy.send.error")
            raise errors.KeysDivergedError(
                keys=keys, origDestination=orig_dest,
                newDestinations=sorted(dests),
            )
        return next(iter(dests))

    def _handle_locally(self, head: Dict[str, Any], body: Any) -> Dict[str, Any]:
        req = {
            "url": head.get("url"),
            "method": head.get("method"),
            "headers": head.get("headers"),
            "httpVersion": head.get("httpVersion"),
            "body": body,
            "ringpopKeys": head.get("ringpopKeys"),
        }
        res = LocalResponse()
        self.ringpop.emit("request", req, res, head)
        return res.wait(self.ringpop.proxy_req_timeout_ms / 1000.0)

    # -- server side ------------------------------------------------------

    def handle_request(self, head: Dict[str, Any], body: Any) -> Dict[str, Any]:
        """The ``/proxy/req`` receive path (request-proxy/index.js:168-229)."""
        self.ringpop.stat("increment", "requestProxy.requests.incoming")
        expected = head.get("ringpopChecksum")
        if expected != self.ringpop.membership.checksum:
            # the differ STAT fires whether or not consistency is
            # enforced; only the rejection is gated
            # (lib/request-proxy/index.js:186-193)
            self.ringpop.stat("increment", "requestProxy.checksumsDiffer")
            self.ringpop.logger.warning(
                "ringpop request proxy checksums differ",
                extra={
                    "local": self.ringpop.whoami(),
                    "expected": expected,
                    "actual": self.ringpop.membership.checksum,
                },
            )
            if self.enforce_consistency:
                raise errors.InvalidCheckSumError(
                    expected=expected,
                    actual=self.ringpop.membership.checksum,
                )
        return self._handle_locally(head, body)

    def destroy(self) -> None:
        self.destroyed = True
