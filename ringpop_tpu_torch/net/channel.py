"""Framed JSON-over-TCP RPC channel — the framework's transport layer.

Plays the role TChannel plays for the reference (SURVEY.md §5.8): endpoints
registered by name, requests carrying ``(head, body)`` JSON payloads,
per-request timeouts, out-of-order responses over a persistent connection.
The usage surface mirrors how ringpop drives TChannel — ``register(endpoint,
handler)`` (server/index.js:28-37) and ``request(...).send(endpoint, head,
body, cb)`` (lib/gossip/ping-sender.js:81-98) — without porting TChannel's
frame format: the wire is length-prefixed JSON, which is sufficient for the
protocol bodies (all of ringpop's bodies are JSON strings already).

Wire format: 4-byte big-endian length, then a JSON object
``{id, type: "req"|"res", endpoint?, head, body, ok?, error?}``.

Threading model: one acceptor thread + one reader thread per connection
(inbound and outbound).  Requests block the calling thread until response or
timeout — gossip runs on its own thread, mirroring the event-loop's
"one protocol period in flight" behavior (gossip/index.js isPinging guard).

The port's copy of ``ringpop_tpu/net/channel.py``, frames and error types
unchanged, so a port node and a JAX node talk to each other.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any, Callable, Dict, Optional, Tuple

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024


class ChannelError(Exception):
    """Transport-level failure (connect/timeout/closed)."""

    def __init__(self, message: str, type_: str = "ringpop-tpu.channel"):
        super().__init__(message)
        self.type = type_


class RemoteError(Exception):
    """The remote handler answered with an application error."""

    def __init__(self, payload: Any):
        super().__init__(str(payload))
        self.payload = payload


Handler = Callable[[Any, Any], Tuple[Any, Any]]


class _Conn:
    """A persistent framed connection with response correlation."""

    def __init__(self, sock: socket.socket, channel: "Channel"):
        self.sock = sock
        self.channel = channel
        self.send_lock = threading.Lock()
        self.pending: Dict[int, "threading.Event"] = {}
        self.responses: Dict[int, dict] = {}
        self.lock = threading.Lock()
        self.closed = False
        self.reader = threading.Thread(target=self._read_loop, daemon=True)
        self.reader.start()

    def _read_loop(self) -> None:
        try:
            buf = b""
            while True:
                while len(buf) < 4:
                    chunk = self.sock.recv(65536)
                    if not chunk:
                        raise ConnectionError("closed")
                    buf += chunk
                (length,) = _LEN.unpack(buf[:4])
                if length > MAX_FRAME:
                    raise ConnectionError("oversized frame")
                buf = buf[4:]
                while len(buf) < length:
                    chunk = self.sock.recv(65536)
                    if not chunk:
                        raise ConnectionError("closed")
                    buf += chunk
                frame, buf = buf[:length], buf[length:]
                msg = json.loads(frame.decode("utf-8"))
                if msg.get("type") == "req":
                    threading.Thread(
                        target=self.channel._dispatch,
                        args=(self, msg),
                        daemon=True,
                    ).start()
                else:
                    with self.lock:
                        ev = self.pending.get(msg.get("id"))
                        if ev is not None:
                            self.responses[msg["id"]] = msg
                            ev.set()
        except (OSError, ConnectionError, ValueError):
            self.close()

    def send_msg(self, msg: dict) -> None:
        data = json.dumps(msg).encode("utf-8")
        with self.send_lock:
            self.sock.sendall(_LEN.pack(len(data)) + data)

    def call(self, msg: dict, timeout_s: float) -> dict:
        ev = threading.Event()
        with self.lock:
            if self.closed:
                raise ChannelError("connection closed")
            self.pending[msg["id"]] = ev
        try:
            self.send_msg(msg)
            if not ev.wait(timeout_s):
                raise ChannelError(
                    "timed out after %.1fs" % timeout_s, "ringpop-tpu.timeout"
                )
            with self.lock:
                res = self.responses.pop(msg["id"], None)
            if res is None:
                raise ChannelError("connection closed mid-request")
            return res
        finally:
            with self.lock:
                self.pending.pop(msg["id"], None)

    def close(self) -> None:
        with self.lock:
            if self.closed:
                return
            self.closed = True
            events = list(self.pending.values())
        try:
            self.sock.close()
        except OSError:
            pass
        for ev in events:
            ev.set()
        self.channel._forget(self)


class Channel:
    """A listening endpoint registry + outbound request pool."""

    def __init__(self, host_port: Optional[str] = None):
        self.host_port = host_port
        self.handlers: Dict[str, Handler] = {}
        self._server_sock: Optional[socket.socket] = None
        self._conns: Dict[str, _Conn] = {}
        self._inbound: list = []
        self._lock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self.destroyed = False

    # -- server side ------------------------------------------------------

    def register(self, endpoint: str, handler: Handler) -> None:
        """``handler(head, body) -> (res_head, res_body)``; raise
        RemoteError(payload) (or any exception) to answer with an error."""
        self.handlers[endpoint] = handler

    def listen(self) -> str:
        host, _, port = (self.host_port or "127.0.0.1:0").rpartition(":")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host or "127.0.0.1", int(port)))
        s.listen(128)
        self._server_sock = s
        self.host_port = "%s:%d" % (host or "127.0.0.1", s.getsockname()[1])
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        return self.host_port

    def _accept_loop(self) -> None:
        try:
            while True:
                sock, _ = self._server_sock.accept()
                # destroy() may have raced with the blocking accept(2): the
                # kernel listener completes handshakes until the acceptor
                # wakes, so a "dead" node must refuse, not serve
                if self.destroyed:
                    sock.close()
                    return
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                with self._lock:
                    self._inbound.append(_Conn(sock, self))
        except OSError:
            pass

    def _dispatch(self, conn: _Conn, msg: dict) -> None:
        if self.destroyed:
            conn.close()
            return
        endpoint = msg.get("endpoint")
        handler = self.handlers.get(endpoint)
        res = {"id": msg["id"], "type": "res"}
        if handler is None:
            res.update(ok=False, error={"type": "ringpop-tpu.bad-endpoint",
                                        "message": "no handler for %r" % endpoint})
        else:
            try:
                head, body = handler(msg.get("head"), msg.get("body"))
                res.update(ok=True, head=head, body=body)
            except RemoteError as e:
                res.update(ok=False, error=e.payload)
            except Exception as e:  # handler bug -> structured error
                res.update(
                    ok=False,
                    error={"type": "ringpop-tpu.handler-error", "message": str(e)},
                )
        try:
            conn.send_msg(res)
        except OSError:
            conn.close()

    # -- client side ------------------------------------------------------

    def _conn_to(self, host_port: str) -> _Conn:
        with self._lock:
            conn = self._conns.get(host_port)
            if conn is not None and not conn.closed:
                return conn
        host, _, port = host_port.rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=5.0)
        # TCP self-connect guard: connecting to a dead peer's (ephemeral)
        # port can pick that very port as the SOURCE and connect the socket
        # to itself — the "peer" then answers with OUR handlers, e.g. a
        # destroyed node appearing to answer pings.  Treat as dead peer.
        if sock.getsockname() == sock.getpeername():
            sock.close()
            raise ConnectionRefusedError(
                "self-connection to %s (peer is down)" % host_port
            )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        conn = _Conn(sock, self)
        with self._lock:
            existing = self._conns.get(host_port)
            if existing is not None and not existing.closed:
                conn.close()
                return existing
            self._conns[host_port] = conn
        return conn

    def _forget(self, conn: _Conn) -> None:
        with self._lock:
            for k, v in list(self._conns.items()):
                if v is conn:
                    del self._conns[k]
            if conn in self._inbound:
                self._inbound.remove(conn)

    def request(
        self,
        host_port: str,
        endpoint: str,
        head: Any = None,
        body: Any = None,
        timeout_s: float = 5.0,
    ) -> Tuple[Any, Any]:
        """Send one request; returns ``(head, body)`` or raises
        ChannelError / RemoteError."""
        if self.destroyed:
            raise ChannelError("channel destroyed")
        with self._id_lock:
            self._next_id += 1
            rid = self._next_id
        msg = {
            "id": rid,
            "type": "req",
            "endpoint": endpoint,
            "head": head,
            "body": body,
        }
        try:
            conn = self._conn_to(host_port)
            res = conn.call(msg, timeout_s)
        except (OSError, ConnectionError) as e:
            raise ChannelError("connect to %s failed: %s" % (host_port, e))
        if not res.get("ok"):
            raise RemoteError(res.get("error"))
        return res.get("head"), res.get("body")

    def destroy(self) -> None:
        self.destroyed = True
        if self._server_sock is not None:
            try:
                # shutdown wakes an acceptor blocked in accept(2); closing
                # alone leaves the kernel listener accepting into the
                # backlog while the thread sleeps (a destroyed node would
                # keep answering pings and refute its own suspicion)
                self._server_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server_sock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns.values()) + list(self._inbound)
        for c in conns:
            c.close()
