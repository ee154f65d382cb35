"""The port's framed JSON-over-TCP channel (``net/channel.py``): the cases
of tests/net/test_channel.py on the port's ``Channel``, and the two
packages' channels talking to each other over real sockets in both
directions (the wire format is kept byte for byte)."""

from __future__ import annotations

import socket
import struct
import threading
import time

import pytest

from ringpop_tpu.net import Channel as JaxChannel
from ringpop_tpu.net import RemoteError as JaxRemoteError
from ringpop_tpu_torch.net import Channel, ChannelError, RemoteError
from ringpop_tpu_torch.net.timers import FakeTimers


# ---- the cases of tests/net/test_channel.py ----

@pytest.fixture
def pair():
    a, b = Channel("127.0.0.1:0"), Channel("127.0.0.1:0")
    a.listen()
    b.listen()
    yield a, b
    a.destroy()
    b.destroy()


def test_request_response(pair):
    a, b = pair
    b.register("/echo", lambda head, body: ({"h": head}, {"b": body}))
    head, body = a.request(b.host_port, "/echo", "hi", [1, 2], timeout_s=2)
    assert head == {"h": "hi"}
    assert body == {"b": [1, 2]}


def test_remote_error(pair):
    a, b = pair

    def boom(head, body):
        raise RemoteError({"type": "ringpop-tpu.test", "message": "nope"})

    b.register("/boom", boom)
    with pytest.raises(RemoteError) as e:
        a.request(b.host_port, "/boom", timeout_s=2)
    assert e.value.payload["type"] == "ringpop-tpu.test"


def test_unknown_endpoint(pair):
    a, b = pair
    with pytest.raises(RemoteError) as e:
        a.request(b.host_port, "/nope", timeout_s=2)
    assert e.value.payload["type"] == "ringpop-tpu.bad-endpoint"


def test_connect_failure():
    a = Channel("127.0.0.1:0")
    a.listen()
    try:
        with pytest.raises(ChannelError):
            a.request("127.0.0.1:1", "/x", timeout_s=2)
    finally:
        a.destroy()


def test_timeout(pair):
    a, b = pair
    release = threading.Event()

    def slow(head, body):
        release.wait(5)
        return None, None

    b.register("/slow", slow)
    t0 = time.time()
    with pytest.raises(ChannelError) as e:
        a.request(b.host_port, "/slow", timeout_s=0.2)
    assert e.value.type == "ringpop-tpu.timeout"
    assert time.time() - t0 < 2
    release.set()


def test_concurrent_out_of_order(pair):
    a, b = pair
    gate = threading.Event()

    def first(head, body):
        gate.wait(5)
        return None, "first"

    def second(head, body):
        return None, "second"

    b.register("/first", first)
    b.register("/second", second)
    results = {}

    def call(ep):
        results[ep] = a.request(b.host_port, ep, timeout_s=5)[1]

    t1 = threading.Thread(target=call, args=("/first",))
    t1.start()
    time.sleep(0.05)
    call("/second")  # completes while /first is parked
    assert results == {"/second": "second"}
    gate.set()
    t1.join(5)
    assert results["/first"] == "first"


def test_bidirectional_over_shared_socket(pair):
    a, b = pair
    a.register("/ping-back", lambda h, body: (None, body + 1))
    b.register("/fwd", lambda h, body: (None, body * 2))
    assert a.request(b.host_port, "/fwd", None, 21, timeout_s=2)[1] == 42
    assert b.request(a.host_port, "/ping-back", None, 1, timeout_s=2)[1] == 2


def test_fake_timers_ordering():
    ft = FakeTimers()
    fired = []
    ft.set_timeout(lambda: fired.append("b"), 2.0)
    h = ft.set_timeout(lambda: fired.append("a"), 1.0)
    ft.set_timeout(lambda: fired.append("c"), 3.0)
    ft.clear_timeout(h)
    assert ft.advance(2.5) == 1
    assert fired == ["b"]
    ft.advance(1.0)
    assert fired == ["b", "c"]
    assert ft.now_ms() > 1414142122274


def test_self_connect_treated_as_dead_peer():
    """Connecting to a freed ephemeral port can self-connect on localhost
    (source port == destination port); the channel must classify that as
    the peer being down, not answer requests with its own handlers."""
    import socket

    from ringpop_tpu_torch.net.channel import Channel, ChannelError

    # deliberately self-connect to prove the phenomenon this guards
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    try:
        s.connect(("127.0.0.1", port))
        assert s.getsockname() == s.getpeername()
    finally:
        s.close()

    ch = Channel("127.0.0.1:0")
    ch.listen()
    try:
        # repeatedly request a dead ephemeral target; without the guard a
        # self-connect would make the request "succeed" via our own
        # handlers — with it, every attempt is a clean ChannelError
        ch.register("/echo", lambda head, body: (head, body))
        dead = "127.0.0.1:%d" % port
        for _ in range(5):
            with pytest.raises(ChannelError):
                ch.request(dead, "/echo", body={"x": 1}, timeout_s=1.0)
    finally:
        ch.destroy()


def test_destroyed_channel_refuses_new_connections():
    """destroy() must wake the blocked acceptor: otherwise the kernel
    listener keeps completing handshakes and a 'dead' node goes on
    answering requests (a destroyed cluster node would refute its own
    suspicion forever)."""
    import time

    from ringpop_tpu_torch.net.channel import Channel, ChannelError, RemoteError

    server = Channel("127.0.0.1:0")
    hp = server.listen()
    server.register("/echo", lambda head, body: (head, body))
    client = Channel("127.0.0.1:0")
    client.listen()
    try:
        _, res = client.request(hp, "/echo", body="x", timeout_s=2.0)
        assert res == "x"
        server.destroy()
        time.sleep(0.05)
        for _ in range(20):
            with pytest.raises((ChannelError, RemoteError)):
                # fresh connection each time: the pooled one died with the
                # server, and new handshakes must now be refused/ignored
                client.request(hp, "/echo", body="y", timeout_s=0.5)
    finally:
        client.destroy()
        server.destroy()


def test_malformed_frame_closes_connection(pair):
    """A peer that sends garbage (a frame that isn't valid JSON) must not
    crash the server — the connection is dropped/errored and the channel
    keeps serving well-formed peers (the proxy layer can therefore never
    see an unparseable head: the transport rejects it first — the analog
    of proxy-test.js:911-955 'handle body failures' / 'non json head')."""
    import socket
    import struct

    a, b = pair
    b.register("/ok", lambda head, body: ("fine", None))

    host, port = b.host_port.split(":")
    raw = socket.create_connection((host, int(port)), timeout=2)
    try:
        garbage = b"\xff\xfenot json at all"
        raw.sendall(struct.pack(">I", len(garbage)) + garbage)
        # server must not hang or crash; it either closes or ignores
        raw.settimeout(2.0)
        try:
            got = raw.recv(65536)
        except (socket.timeout, ConnectionResetError, OSError):
            got = b""
    finally:
        raw.close()
    del got  # any response (or close) is fine; the invariant is below

    # the channel still serves well-formed requests afterwards
    head, _ = a.request(b.host_port, "/ok", None, None, timeout_s=2)
    assert head == "fine"


# ---- the port's channel and the JAX package's, on one wire ----


@pytest.fixture
def mixed():
    p, j = Channel("127.0.0.1:0"), JaxChannel("127.0.0.1:0")
    p.listen()
    j.listen()
    yield p, j
    p.destroy()
    j.destroy()


def test_port_calls_jax_and_jax_calls_port(mixed):
    p, j = mixed
    j.register("/echo", lambda head, body: ({"from": "jax", "h": head}, {"b": body}))
    p.register("/echo", lambda head, body: ({"from": "port", "h": head}, {"b": body}))
    assert p.request(j.host_port, "/echo", "hi", [1, {"x": 2}], timeout_s=2) == (
        {"from": "jax", "h": "hi"}, {"b": [1, {"x": 2}]})
    assert j.request(p.host_port, "/echo", None, "s", timeout_s=2) == (
        {"from": "port", "h": None}, {"b": "s"})


def test_remote_errors_cross_packages(mixed):
    p, j = mixed

    def boom(head, body):
        raise RuntimeError("nope")

    j.register("/boom", boom)
    p.register("/boom", boom)
    with pytest.raises(RemoteError) as e:
        p.request(j.host_port, "/boom", None, None, timeout_s=2)
    assert e.value.payload["type"] == "ringpop-tpu.handler-error"
    with pytest.raises(JaxRemoteError) as e2:
        j.request(p.host_port, "/missing", None, None, timeout_s=2)
    assert e2.value.payload["type"] == "ringpop-tpu.bad-endpoint"


def _frames(channel_cls):
    """The bytes a channel writes for one request, read off a raw socket."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    ch = channel_cls("127.0.0.1:0")
    ch.listen()
    got = {}

    def serve():
        conn, _ = srv.accept()
        n = struct.unpack(">I", conn.recv(4, socket.MSG_WAITALL))[0]
        got["frame"] = conn.recv(n, socket.MSG_WAITALL)
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        ch.request("127.0.0.1:%d" % port, "/protocol/ping", {"a": 1}, {"checksum": 7},
                   timeout_s=0.5)
    except ChannelError:
        pass
    except Exception:  # the JAX channel raises its own ChannelError type
        pass
    t.join(5)
    ch.destroy()
    srv.close()
    return got["frame"]


def test_request_frames_are_byte_equal():
    assert _frames(Channel) == _frames(JaxChannel)
