"""The port's protocol and admin endpoints over a live in-process cluster:
the cases of tests/integration/test_server_admin.py on the port's
``Ringpop``, server and client (tests/_torch_cluster.py's cluster)."""

from __future__ import annotations

import pytest

from ringpop_tpu_torch.api.client import RingpopClient
from ringpop_tpu_torch.net.channel import RemoteError
from tests._torch_cluster import LiveCluster


# ---- the cases of tests/integration/test_server_admin.py ----

@pytest.fixture
def cluster():
    made = []

    def make(n=3, **kw):
        c = LiveCluster(n=n, **kw)
        made.append(c)
        c.bootstrap_all()
        c.tick_until_converged()
        return c

    yield make
    for c in made:
        c.destroy_all()


@pytest.fixture
def client():
    cl = RingpopClient()
    yield cl
    cl.destroy()


# -- /protocol/join validation (server/protocol/join.js:53-135) -----------


def test_join_rejects_self(cluster):
    c = cluster(n=2)
    rp = c.node(0)
    with pytest.raises(RemoteError):
        rp.channel.request(
            rp.whoami(),
            "/protocol/join",
            body={
                "app": rp.app,
                "source": rp.whoami(),
                "incarnationNumber": 1,
            },
        )


def test_join_rejects_wrong_app(cluster):
    c = cluster(n=2)
    rp = c.node(0)
    with pytest.raises(RemoteError) as e:
        c.node(1).channel.request(
            rp.whoami(),
            "/protocol/join",
            body={
                "app": "some-other-app",
                "source": c.node(1).whoami(),
                "incarnationNumber": 1,
            },
        )
    assert "app" in str(e.value).lower()


def test_join_rejects_blacklisted(cluster):
    import re

    c = cluster(n=2)
    rp = c.node(0)
    rp.config.set("memberBlacklist", [re.compile(r"127\.0\.0\.1:19\d+")])
    with pytest.raises(RemoteError):
        c.node(1).channel.request(
            rp.whoami(),
            "/protocol/join",
            body={
                "app": rp.app,
                "source": "127.0.0.1:19001",
                "incarnationNumber": 1,
            },
        )


def test_join_replies_full_membership(cluster):
    c = cluster(n=3)
    rp = c.node(0)
    joiner = "127.0.0.1:18999"
    _, res = c.node(1).channel.request(
        rp.whoami(),
        "/protocol/join",
        body={"app": rp.app, "source": joiner, "incarnationNumber": 7},
    )
    assert res["coordinator"] == rp.whoami()
    assert res["membershipChecksum"] == rp.membership.checksum
    addrs = {m["address"] for m in res["membership"]}
    assert joiner in addrs and set(c.hosts) <= addrs


def test_ping_requires_ready():
    c = LiveCluster(n=1)
    rp = c.node(0)
    try:
        with pytest.raises(RemoteError):
            rp.channel.request(rp.whoami(), "/protocol/ping", body={})
    finally:
        c.destroy_all()


# -- admin endpoints over the admin client (client.js) --------------------


def test_admin_client_surface(cluster, client):
    c = cluster(n=3)
    hp = c.node(0).whoami()

    assert client.health(hp) == "ok"
    assert client.admin_gossip_status(hp)["status"] == "running"
    client.admin_gossip_stop(hp)
    assert client.admin_gossip_status(hp)["status"] == "stopped"
    client.admin_gossip_start(hp)
    assert client.admin_gossip_status(hp)["status"] == "running"

    tick = client.admin_gossip_tick(hp)
    assert tick["checksum"] == c.node(0).membership.checksum

    stats = client.admin_stats(hp)
    assert stats["ring"] == sorted(c.hosts)
    assert {m["address"] for m in stats["membership"]["members"]} == set(
        c.hosts
    )

    looked = client.admin_lookup(hp, "some-key")
    assert looked["dest"] in c.hosts

    cfg = client.admin_config_get(hp)
    assert "TEST_KEY" in cfg
    client.admin_config_set(hp, {"TEST_KEY": 42})
    assert client.admin_config_get(hp)["TEST_KEY"] == 42


def test_admin_debug_flags(cluster, client):
    c = cluster(n=2)
    hp = c.node(0).whoami()
    c.node(0).channel.request(hp, "/admin/debugSet", body={"debugFlag": "p"})
    assert c.node(0).debug_flag_enabled("p")
    c.node(0).channel.request(hp, "/admin/debugClear", body={})
    assert not c.node(0).debug_flag_enabled("p")


def test_admin_metrics_renders_prometheus_text(cluster):
    """/admin/metrics — Prometheus text exposition next to /admin/stats
    (obs.prometheus.render_ringpop_metrics over the channel)."""
    c = cluster(n=3)
    rp = c.node(0)
    head, body = c.node(1).channel.request(
        rp.whoami(), "/admin/metrics", body={}
    )
    assert head["contentType"].startswith("text/plain")
    assert isinstance(body, str) and body.strip()
    assert "# TYPE ringpop_members gauge" in body
    assert "ringpop_members{" in body
    assert 'instance="%s"' % rp.whoami() in body
    assert "ringpop_membership_checksum" in body
    # a converged 3-node cluster: every member alive on the serving node
    assert 'ringpop_members_by_status{' in body
    assert 'status="alive"' in body
    assert "ringpop_ring_servers" in body
    # request meters moved — this very request marked the server plane
    assert 'ringpop_requests_total{' in body


# -- trace subsystem over the wire (lib/trace/) ---------------------------


def test_trace_add_fires_sink_and_removes(cluster):
    c = cluster(n=2)
    source, collector = c.node(0), c.node(1)
    received = []

    def sink(head, body):
        received.append((head, body))
        return None, "ok"

    collector.channel.register("/trace/sink", sink)
    _, res = collector.channel.request(
        source.whoami(),
        "/trace/add",
        body={
            "event": "membership.checksum.update",
            "sink": {
                "type": "channel",
                "hostPort": collector.whoami(),
                "serviceName": "/trace/sink",
            },
            "expiresIn": 60000,
        },
    )
    assert res["status"] == "ok"
    # force a checksum change on the source -> tap fires -> sink called
    source.membership.update(
        {
            "address": "127.0.0.1:18777",
            "status": "alive",
            "incarnationNumber": 3,
            "source": source.whoami(),
            "sourceIncarnationNumber": 3,
        }
    )
    import time

    for _ in range(50):
        if received:
            break
        time.sleep(0.05)
    assert received, "trace channel sink never fired"
    head, body = received[0]
    assert head["event"] == "membership.checksum.update"
    assert body["checksum"] == source.membership.checksum

    _, res = collector.channel.request(
        source.whoami(),
        "/trace/remove",
        body={
            "event": "membership.checksum.update",
            "sink": {
                "type": "channel",
                "hostPort": collector.whoami(),
                "serviceName": "/trace/sink",
            },
        },
    )
    assert res["status"] == "ok"


def test_trace_add_unknown_event_rejected(cluster):
    c = cluster(n=2)
    with pytest.raises(RemoteError):
        c.node(1).channel.request(
            c.node(0).whoami(),
            "/trace/add",
            body={"event": "no.such.event", "sink": {"type": "log"}},
        )
