"""The port's live node, in process and as processes.

- The cases of tests/integration/test_cluster.py on the port's
  ``Ringpop`` (tests/_torch_cluster.py: the in-process cluster of
  tests/lib/cluster.py with ``FakeTimers`` and ports from the OS, copied).
- A mixed cluster: two JAX ``Ringpop``s and two port ``Ringpop``s in one
  process over real sockets converge to one checksum, agree on the owner
  of 100 keys and forward proxied requests across the two packages.
- ``/admin/metrics``: the port's ``render_ringpop_metrics`` equal to
  JAX's on the same node.
- ``TickCluster.create("live", 3)``: three node processes of the port
  converge, and the two survivors of a kill agree again.
"""

from __future__ import annotations

import time

import pytest

from ringpop_tpu_torch.gossip.join_sender import JoinError
from ringpop_tpu_torch.models.membership.host import Status
from tests._torch_cluster import LiveCluster


# ---- the cases of tests/integration/test_cluster.py ----

@pytest.fixture
def cluster():
    made = []

    def make(n=5, **kw):
        c = LiveCluster(n=n, **kw)
        made.append(c)
        return c

    yield make
    for c in made:
        c.destroy_all()


def test_bootstrap_converges(cluster):
    c = cluster(n=5)
    c.bootstrap_all()
    ticks = c.tick_until_converged()
    assert ticks <= 60
    for rp in c.nodes:
        assert rp.membership.get_member_count() == 5
        assert sorted(rp.ring.servers) == sorted(c.hosts)
        assert rp.membership.checksum is not None


def test_kill_suspect_then_faulty(cluster):
    c = cluster(n=5)
    c.bootstrap_all()
    c.tick_until_converged()
    victim = c.node(2)
    victim_addr = victim.whoami()
    victim.destroy()  # SIGKILL equivalent: sockets die, no goodbye

    # gossip: someone's direct ping fails, ping-req finds no path -> suspect
    for _ in range(30):
        c.tick_all()
        if any(
            s == Status.suspect for s in c.statuses_of(victim_addr).values()
        ):
            break
    assert any(
        s == Status.suspect for s in c.statuses_of(victim_addr).values()
    ), c.statuses_of(victim_addr)

    # suspicion clocks expire (5s virtual) -> faulty, disseminated to all
    for _ in range(40):
        c.advance_all(6.0)
        c.tick_all()
        statuses = c.statuses_of(victim_addr)
        if all(s == Status.faulty for s in statuses.values()):
            break
    assert all(
        s == Status.faulty for s in c.statuses_of(victim_addr).values()
    ), c.statuses_of(victim_addr)
    c.tick_until_converged()
    # faulty members leave the ring but stay in the member list
    for rp in c.live():
        assert victim_addr not in rp.ring.servers
        assert rp.membership.find_member_by_address(victim_addr) is not None


def test_wrongly_suspected_node_refutes(cluster):
    c = cluster(n=4)
    c.bootstrap_all()
    c.tick_until_converged()
    accuser, accused = c.node(0), c.node(1)
    inc_before = accused.membership.local_member.incarnation_number
    # accuser wrongly declares the (live) accused suspect
    m = accuser.membership.find_member_by_address(accused.whoami())
    accuser.membership.make_suspect(accused.whoami(), m.incarnation_number)
    assert c.status_of(accuser, accused.whoami()) == Status.suspect

    # accused's own clock must move past the stale incarnation so the
    # refute is fresh (incarnations are clock-derived, member.js:78-81)
    accused.timers.advance(1.0)
    for _ in range(40):
        c.tick_all()
        statuses = c.statuses_of(accused.whoami())
        if all(s == Status.alive for s in statuses.values()):
            break
    assert all(
        s == Status.alive for s in c.statuses_of(accused.whoami()).values()
    ), c.statuses_of(accused.whoami())
    assert (
        accused.membership.local_member.incarnation_number > inc_before
    ), "refute must bump the incarnation number"
    c.tick_until_converged()


def test_leave_and_rejoin(cluster):
    c = cluster(n=4)
    c.bootstrap_all()
    c.tick_until_converged()
    leaver = c.node(3)
    addr = leaver.whoami()

    _, res = leaver.server.admin_member_leave(None, {})
    assert res["status"] == "ok"
    # LocalMemberLeaveEvent stops the leaver's gossip
    assert leaver.gossip.is_stopped
    for _ in range(40):
        c.tick_all()
        statuses = {
            k: v for k, v in c.statuses_of(addr).items()
        }
        if all(s == Status.leave for s in statuses.values()):
            break
    assert all(
        s == Status.leave for s in c.statuses_of(addr).values()
    ), c.statuses_of(addr)
    for rp in c.live():
        if rp.whoami() != addr:
            assert addr not in rp.ring.servers

    # rejoin: fresh incarnation, gossip restarted, back in every ring
    leaver.timers.advance(1.0)
    _, res = leaver.server.admin_member_join(None, {})
    assert res["status"] == "rejoined"
    assert not leaver.gossip.is_stopped
    for _ in range(60):
        c.tick_all()
        if all(
            s == Status.alive for s in c.statuses_of(addr).values()
        ):
            break
    assert all(s == Status.alive for s in c.statuses_of(addr).values())
    c.tick_until_converged()
    for rp in c.live():
        assert addr in rp.ring.servers


def test_deny_joins(cluster):
    def deny(cl):
        for rp in cl.nodes[1:]:
            rp.deny_joins()

    c = cluster(n=3, tap=deny)
    joiner = c.node(0)
    for rp in c.nodes[1:]:
        rp.bootstrap([rp.whoami()])  # bring up targets standalone
    with pytest.raises(JoinError):
        joiner.bootstrap({"bootstrapFile": c.hosts, "maxJoinDuration": 2000})


def test_full_sync_recovers_divergence(cluster):
    """A node whose change buffer is empty but whose checksum differs gets
    the target's full membership (dissemination.js:101-114)."""
    c = cluster(n=3)
    c.bootstrap_all()
    c.tick_until_converged()
    # fabricate divergence: node0 learns of a phantom member directly, with
    # the change buffer cleared so only full-sync can repair the others
    phantom = "127.0.0.1:19999"
    c.node(0).membership.update(
        {
            "address": phantom,
            "status": Status.faulty,
            "incarnationNumber": 1,
            "source": c.node(0).whoami(),
            "sourceIncarnationNumber": 1,
        }
    )
    c.node(0).dissemination.clear_changes()
    assert not c.converged()
    c.tick_until_converged(max_ticks=40)
    for rp in c.live():
        assert rp.membership.find_member_by_address(phantom) is not None


def test_join_failure_triage_stats(cluster):
    """Failed join attempts are triaged by error type and surfaced in the
    join result (join-sender.js:233-283 stats)."""
    c = cluster(n=4)

    def deny(rp):
        rp.deny_joins()

    # one denier + one dead address in the bootstrap list
    c.node(1).deny_joins()
    for rp in c.nodes[1:]:
        rp.bootstrap([rp.whoami()])

    joiner = c.node(0)
    hosts = c.hosts + ["127.0.0.1:1"]
    joiner.membership.make_alive(joiner.whoami(), joiner.timers.now_ms())
    from ringpop_tpu_torch.gossip.join_sender import join_cluster

    joiner.bootstrap_hosts = hosts
    result = join_cluster(
        joiner, {"joinSize": 2, "joinTimeout": 500, "maxJoinDuration": 10000}
    )
    assert result["numJoined"] >= 2
    assert result["numGroups"] >= 1
    if result["numFailed"]:
        assert all("errType" in f for f in result["failures"])


# ---- a mixed cluster: JAX nodes and port nodes on one wire ----


def _mixed_kinds():
    from ringpop_tpu.api.ringpop import Ringpop as JaxRingpop
    from ringpop_tpu.net.channel import Channel as JaxChannel
    from ringpop_tpu.net.timers import FakeTimers as JaxFakeTimers

    from tests._torch_cluster import PORT_KIND

    jax_kind = (JaxRingpop, JaxChannel, JaxFakeTimers)
    return [jax_kind, jax_kind, PORT_KIND, PORT_KIND]


@pytest.fixture
def mixed():
    c = LiveCluster(n=4, app="mixed-app", kinds=_mixed_kinds())
    yield c
    c.destroy_all()


def test_mixed_cluster_converges_and_agrees_on_owners(mixed):
    c = mixed
    assert [type(rp).__module__.split(".")[0] for rp in c.nodes] == [
        "ringpop_tpu", "ringpop_tpu", "ringpop_tpu_torch", "ringpop_tpu_torch"]
    c.bootstrap_all()
    c.tick_until_converged()
    assert len(set(c.checksums().values())) == 1
    assert {rp.ring.checksum for rp in c.nodes} == {c.nodes[0].ring.checksum}
    keys = ["key-%d" % i for i in range(100)]
    owners = [[rp.lookup(k) for k in keys] for rp in c.nodes]
    assert all(o == owners[0] for o in owners)
    assert set(owners[0]) == set(c.hosts)  # every node owns some of 100 keys
    assert [rp.lookup_n("key-0", 3) for rp in c.nodes] == [c.nodes[0].lookup_n("key-0", 3)] * 4


def test_mixed_cluster_proxies_across_packages(mixed):
    c = mixed
    c.bootstrap_all()
    c.tick_until_converged()
    for rp in c.nodes:
        def handler(req, res, head, rp=rp):
            res.end({"handledBy": rp.whoami(), "keys": req.get("ringpopKeys")})
        rp.on("request", handler)

    def key_of(owner, tag):
        for i in range(10000):
            key = "%s-%d" % (tag, i)
            if c.node(0).lookup(key) == owner.whoami():
                return key
        raise AssertionError("no key for %s" % owner.whoami())

    # every sender forwards to an owner of the other package
    for s, d in ((0, 2), (1, 3), (2, 0), (3, 1)):
        sender, owner = c.node(s), c.node(d)
        key = key_of(owner, "x%d" % s)
        got = {}
        orig = sender.request_proxy.proxy_req

        def spy(opts, orig=orig, got=got):
            res = orig(opts)
            got.update(res)
            return res

        sender.request_proxy.proxy_req = spy
        assert sender.handle_or_proxy(key, {"url": "/x"}) is False
        assert got["body"] == {"handledBy": owner.whoami(), "keys": [key]}, (s, d)


def test_mixed_cluster_reconverges_after_a_port_node_dies(mixed):
    c = mixed
    c.bootstrap_all()
    c.tick_until_converged()
    victim = c.node(3)
    victim.destroy()
    for _ in range(40):
        c.tick_all()
        c.advance_all(6.0)  # past the suspicion timeout on every survivor
        if c.converged() and all(
                c.status_of(rp, victim.whoami()) == "faulty" for rp in c.live()):
            break
    assert c.converged() and len(c.live()) == 3
    assert all(c.status_of(rp, victim.whoami()) == "faulty" for rp in c.live())


# ---- /admin/metrics against the JAX package's renderer ----


def test_render_ringpop_metrics_equal_jax(mixed):
    from ringpop_tpu.obs import prometheus as jprom

    from ringpop_tpu_torch.obs import prometheus as pprom

    c = mixed
    c.bootstrap_all()
    c.tick_until_converged()

    def body(render, rp):
        # the uptime gauge reads the wall clock at render time
        return [line for line in render(rp).splitlines()
                if not line.startswith("ringpop_uptime_seconds")]

    for rp in c.nodes:
        got = body(pprom.render_ringpop_metrics, rp)
        assert got == body(jprom.render_ringpop_metrics, rp)
        assert any(line.startswith("ringpop_members_by_status{") for line in got)


# ---- the port's live processes through TickCluster ----


LIVE_TIME_LIMIT_S = 120.0  # the whole three-process test, start to teardown


def test_live_backend_three_processes(tmp_path):
    """Three node processes of the port (``python -m
    ringpop_tpu_torch.api.cli``) on ports from a range no other test uses:
    converge, SIGKILL one, the two survivors agree again and name the
    same owners.  Every wait shares one deadline, the test's time limit."""
    from ringpop_tpu_torch.api.tick_cluster import TickCluster

    deadline = time.monotonic() + LIVE_TIME_LIMIT_S
    tc = TickCluster.create("live", 3, base_port=24310,
                            hosts_file=str(tmp_path / "hosts.json"))
    try:
        tc.backend.start(startup_timeout_s=60.0)
        while time.monotonic() < deadline:
            tc.tick()
            if tc.converged() and None not in tc.checksum_groups():
                break
            time.sleep(0.05)
        assert tc.converged() and None not in tc.checksum_groups()

        tc.backend.kill(2)
        dead = tc.backend.hosts[2]
        while time.monotonic() < deadline:
            tc.tick()
            groups = tc.checksum_groups()
            rings = [tc.backend.client.admin_stats(h)["ring"] for h in tc.backend.hosts[:2]]
            if groups.get(None) == [dead] and tc.converged() and all(dead not in r for r in rings):
                break
            time.sleep(0.2)
        assert tc.checksum_groups().get(None) == [dead] and tc.converged()
        keys = ["k%d" % i for i in range(20)]
        assert [tc.backend.lookup(k, 0) for k in keys] == [tc.backend.lookup(k, 1) for k in keys]
        assert dead not in {tc.backend.lookup(k, 0) for k in keys}
    finally:
        tc.destroy()
    assert time.monotonic() < deadline


def test_cli_requires_listen_and_hosts():
    from ringpop_tpu_torch.api.cli import main

    assert main([]) == 1
    assert main(["--listen", "127.0.0.1:9"]) == 1


@pytest.mark.slow
def test_live_backend_four_processes_kill_suspend_revive(tmp_path):
    """tests/integration/test_tick_cluster.py's slow live case on the port:
    four processes converge, SIGKILL one, SIGSTOP another, revive both,
    reconverge (tick-cluster.js:351-470).  Slow, as the JAX one is."""
    from ringpop_tpu_torch.api.tick_cluster import TickCluster

    tc = TickCluster.create("live", 4, base_port=24330,
                            hosts_file=str(tmp_path / "hosts.json"))
    try:
        tc.start()
        for _ in range(120):
            tc.tick()
            if tc.converged() and None not in tc.checksum_groups():
                break
            time.sleep(0.05)
        assert tc.converged()
        tc.backend.kill(1)
        tc.backend.suspend(2)
        down = {tc.backend.hosts[1], tc.backend.hosts[2]}
        deadline = time.time() + 60
        while time.time() < deadline:
            tc.tick()
            if down <= set(tc.checksum_groups().get(None, [])):
                break
            time.sleep(0.1)
        assert down <= set(tc.checksum_groups().get(None, []))
        tc.backend.revive(1)
        tc.backend.revive(2)
        deadline = time.time() + 90
        while time.time() < deadline:
            tc.tick()
            if None not in tc.checksum_groups() and tc.converged():
                break
            time.sleep(0.2)
        assert None not in tc.checksum_groups() and tc.converged()
    finally:
        tc.destroy()


@pytest.mark.slow
def test_cli_single_node(tmp_path):
    """The port's CLI starts, bootstraps a one-node cluster, answers
    /health and exits on SIGTERM (main.js:24-85).  Slow, as the JAX one is."""
    import json
    import os
    import subprocess
    import sys

    from ringpop_tpu_torch.api.client import RingpopClient
    from ringpop_tpu_torch.api.tick_cluster import generate_hosts

    hosts_file = str(tmp_path / "hosts.json")
    hp = "127.0.0.1:24390"
    generate_hosts(hosts_file, 1, base_port=24390)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ringpop_tpu_torch.api.cli", "--listen", hp, "--hosts",
         hosts_file, "--quiet"],
        env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
    )
    try:
        assert json.loads(proc.stdout.readline().decode()) == {"listening": hp, "ready": True}
        cl = RingpopClient()
        assert cl.health(hp) == "ok"
        assert cl.admin_gossip_status(hp)["status"] == "running"
        cl.destroy()
    finally:
        proc.terminate()
        assert proc.wait(10.0) == 0
