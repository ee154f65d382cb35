"""Request forwarding over a live cluster of the port's nodes: the cases of
tests/integration/test_proxy.py (handle-or-proxy, retries with re-lookup
and reroute, keys-diverged abort, checksum-mismatch rejection,
handle_or_proxy_all grouping, the sk-header sharding handler) on the
port's ``Ringpop``, over the in-process cluster of tests/_torch_cluster.py
(tests/lib/cluster.py's, copied)."""

from __future__ import annotations

import pytest

from ringpop_tpu_torch.utils import errors
from tests._torch_cluster import LiveCluster


# ---- the cases of tests/integration/test_proxy.py ----

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


def wire_echo_handlers(c):
    """Every node answers proxied requests with its own identity."""
    for rp in c.nodes:
        def handler(req, res, head, rp=rp):
            res.end(
                {"handledBy": rp.whoami(), "keys": req.get("ringpopKeys")},
            )
        rp.on("request", handler)


def key_owned_by(c, owner, tag="k"):
    """A key whose ring owner is `owner` in everyone's converged view."""
    for i in range(10000):
        key = "%s-%d" % (tag, i)
        if c.node(0).lookup(key) == owner.whoami():
            return key
    raise AssertionError("no key found for %s" % owner.whoami())


def test_handle_or_proxy_local_and_remote(cluster):
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, remote = c.node(0), c.node(1)
    local_key = key_owned_by(c, sender)
    remote_key = key_owned_by(c, remote)

    assert sender.handle_or_proxy(local_key, {"url": "/x"}) is True

    captured = {}
    orig = sender.request_proxy.proxy_req

    def spy(opts):
        res = orig(opts)
        captured.update(res)
        return res

    sender.request_proxy.proxy_req = spy
    assert sender.handle_or_proxy(remote_key, {"url": "/x"}) is False
    assert captured["body"]["handledBy"] == remote.whoami()
    assert captured["body"]["keys"] == [remote_key]


def test_handle_or_proxy_all_groups_by_owner(cluster):
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender = c.node(0)
    keys = [key_owned_by(c, rp, tag="g%d" % i) for i, rp in enumerate(c.nodes)]
    results = sender.handle_or_proxy_all(keys, {"url": "/all"})
    assert len(results) == 3
    by_dest = {r["dest"]: r for r in results}
    for rp, key in zip(c.nodes, keys):
        entry = by_dest[rp.whoami()]
        assert entry["keys"] == [key]
        assert "error" not in entry
        assert entry["res"]["body"]["handledBy"] == rp.whoami()


def test_checksum_mismatch_rejected_then_retried_to_success(cluster):
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, dest = c.node(0), c.node(1)
    key = key_owned_by(c, dest)
    # destabilize the DEST's checksum so the first attempt is rejected;
    # convergence repairs it and the retry (after re-lookup) succeeds
    phantom = "127.0.0.1:19998"
    dest.membership.update(
        {
            "address": phantom,
            "status": "faulty",
            "incarnationNumber": 1,
            "source": dest.whoami(),
            "sourceIncarnationNumber": 1,
        }
    )
    stats_before = _stat_count(sender, "requestProxy.retry.attempted")

    # background convergence: the proxy retry sleeps on FakeTimers, so we
    # drive gossip from a thread while proxy_req blocks — until the
    # request completes (a fixed iteration count raced the retry
    # schedule and flaked under load)
    import threading
    import time as _time

    done = threading.Event()

    def converge():
        deadline = _time.monotonic() + 30.0
        while not done.is_set() and _time.monotonic() < deadline:
            c.tick_all()
            sender.timers.advance(2.0)
            _time.sleep(0.001)

    t = threading.Thread(target=converge, daemon=True)
    t.start()
    try:
        res = sender.proxy_req(
            {"keys": [key], "dest": dest.whoami(), "req": {"url": "/y"}}
        )
    finally:
        done.set()
    t.join(10.0)
    assert res["body"]["handledBy"] in {rp.whoami() for rp in c.nodes}
    assert (
        _stat_count(sender, "requestProxy.retry.attempted") > stats_before
    ), "first attempt should have been checksum-rejected and retried"


def test_keys_diverged_aborts_retry(cluster):
    c = cluster(n=3)
    sender = c.node(0)
    k1 = key_owned_by(c, c.node(1), tag="d1")
    k2 = key_owned_by(c, c.node(2), tag="d2")
    with pytest.raises(errors.KeysDivergedError):
        sender.request_proxy._relookup([k1, k2], c.node(1).whoami())


def test_retry_reroutes_to_new_owner(cluster):
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, old_owner = c.node(0), c.node(1)
    key = key_owned_by(c, old_owner)
    # point the first attempt at a dead address: retries re-lookup and
    # reroute to the real owner (send.js:181-208)
    dead = "127.0.0.1:1"
    res = sender.proxy_req(
        {"keys": [key], "dest": dead, "req": {"url": "/z"}}
    )
    assert res["body"]["handledBy"] == old_owner.whoami()


def test_sharding_handler_relays_by_sk(cluster):
    from ringpop_tpu_torch.api.handler import RingpopHandler

    c = cluster(n=3)
    for rp in c.nodes:
        def app_handler(head, body, rp=rp):
            return None, {"servedBy": rp.whoami(), "echo": body}

        RingpopHandler(rp, app_handler, "/app/op").register()

    sender, other = c.node(0), c.node(2)
    sk = key_owned_by(c, other, tag="sk")
    _, body = sender.channel.request(
        sender.whoami(), "/app/op", head={"sk": sk}, body={"v": 1}
    )
    assert body["servedBy"] == other.whoami()
    assert body["echo"] == {"v": 1}

    sk_local = key_owned_by(c, sender, tag="skl")
    _, body = sender.channel.request(
        sender.whoami(), "/app/op", head={"sk": sk_local}, body={"v": 2}
    )
    assert body["servedBy"] == sender.whoami()


def _stat_count(rp, suffix):
    # NullStatsd records nothing; count via the stat-key cache side effect
    # is unreliable — attach a counting statsd instead
    return getattr(rp, "_test_counts", {}).get(suffix, 0)


@pytest.fixture(autouse=True)
def counting_statsd(monkeypatch):
    """Wrap Ringpop.stat to count increments per suffix for assertions."""
    from ringpop_tpu_torch.api.ringpop import Ringpop

    orig = Ringpop.stat

    def counting(self, stat_type, key, value=None):
        if stat_type == "increment":
            counts = getattr(self, "_test_counts", None)
            if counts is None:
                counts = self._test_counts = {}
            counts[key] = counts.get(key, 0) + 1
        return orig(self, stat_type, key, value)

    monkeypatch.setattr(Ringpop, "stat", counting)


def test_sharding_handler_blacklist_passes_through(cluster):
    """Blacklisted endpoints skip sk routing entirely
    (ringpop-handler.js:52-68)."""
    from ringpop_tpu_torch.api.handler import RingpopHandler

    c = cluster(n=3)
    sender, other = c.node(0), c.node(1)

    def app_handler(head, body):
        return None, {"servedBy": sender.whoami()}

    RingpopHandler(
        sender, app_handler, "/app/admin-ish", blacklist=["/app/admin-ish"]
    ).register()
    sk = key_owned_by(c, other, tag="bl")
    # even with a remote-owned sk, the blacklist serves locally
    _, body = sender.channel.request(
        sender.whoami(), "/app/admin-ish", head={"sk": sk}, body={}
    )
    assert body["servedBy"] == sender.whoami()


def test_sharding_handler_no_sk_serves_locally(cluster):
    from ringpop_tpu_torch.api.handler import RingpopHandler

    c = cluster(n=2)
    sender = c.node(0)
    RingpopHandler(
        sender, lambda h, b: (None, {"servedBy": sender.whoami()}), "/app/nosk"
    ).register()
    _, body = sender.channel.request(
        sender.whoami(), "/app/nosk", head={}, body={}
    )
    assert body["servedBy"] == sender.whoami()


def test_body_limit_enforced_and_at_limit_passes(cluster):
    """Oversized buffered bodies fail the forward with the body-module's
    413 (lib/request-proxy/index.js:88-100); a body exactly at the limit
    forwards fine (proxy-test.js 'proxies big json').  Like the
    reference, enforcement is sender-side only: handleRequest
    (index.js:168-229) never re-checks the limit on the receive path."""
    c = cluster(n=2)
    wire_echo_handlers(c)
    sender, dest = c.node(0), c.node(1)
    key = key_owned_by(c, dest, tag="bl")

    big = "x" * 512
    limit = len('"%s"' % big)  # serialized length, like the raw stream
    res = sender.proxy_req(
        {
            "keys": [key],
            "dest": dest.whoami(),
            "req": {"url": "/b", "body": big},
            "bodyLimit": limit,
        }
    )
    assert res["body"]["handledBy"] == dest.whoami()

    with pytest.raises(errors.BodyLimitExceededError) as ei:
        sender.proxy_req(
            {
                "keys": [key],
                "dest": dest.whoami(),
                "req": {"url": "/b", "body": big + "y"},
                "bodyLimit": limit,
            }
        )
    assert ei.value.fields["limit"] == limit
    assert ei.value.fields["length"] > limit


def test_max_retries_zero_fails_fast(cluster):
    """maxRetries=0: a failed first attempt raises immediately with no
    retry (proxy-test.js requestProxyMaxRetries:0)."""
    c = cluster(n=2)
    sender = c.node(0)
    before = _stat_count(sender, "requestProxy.retry.attempted")
    with pytest.raises(errors.MaxRetriesExceededError):
        sender.proxy_req(
            {
                "keys": ["k"],
                "dest": "127.0.0.1:1",
                "req": {"url": "/x"},
                "maxRetries": 0,
            }
        )
    assert _stat_count(sender, "requestProxy.retry.attempted") == before
    assert _stat_count(sender, "requestProxy.retry.failed") >= 1


def test_max_retries_five_exhaustion_counts_attempts(cluster):
    """maxRetries=5 against a permanently-dead owner retries exactly 5
    times, then fails (proxy-test.js requestProxyMaxRetries:5)."""
    c = cluster(n=2)
    sender = c.node(0)
    sender.request_proxy.retry_schedule_s = [0.0]
    # a key that re-looks-up to a dead address every time: phantom member
    # added to the SENDER's ring only
    phantom = "127.0.0.1:19997"
    sender.ring.add_server(phantom)
    key = None
    for i in range(10000):
        k = "ex-%d" % i
        if sender.lookup(k) == phantom:
            key = k
            break
    assert key is not None
    before = _stat_count(sender, "requestProxy.retry.attempted")
    with pytest.raises(errors.MaxRetriesExceededError) as ei:
        sender.proxy_req(
            {
                "keys": [key],
                "dest": phantom,
                "req": {"url": "/x"},
                "maxRetries": 5,
            }
        )
    assert ei.value.fields["maxRetries"] == 5
    assert _stat_count(sender, "requestProxy.retry.attempted") - before == 5


def test_destroy_mid_retry_aborts_forwarding(cluster):
    """A proxy destroyed between attempts aborts the in-flight retry
    ('Channel was destroyed before forwarding attempt',
    proxy-test.js:1039-1063)."""
    c = cluster(n=2)
    sender = c.node(0)
    sender.request_proxy.retry_schedule_s = [0.0]
    remote = c.node(1).whoami()

    def destroy_then_relookup(keys, dest):
        # destroyed between attempts; re-route lands on a REMOTE owner so
        # the loop re-enters its pre-attempt destroyed check
        sender.request_proxy.destroy()
        return remote

    sender.request_proxy._relookup = destroy_then_relookup
    with pytest.raises(errors.RequestProxyDestroyedError):
        sender.proxy_req(
            {"keys": ["k"], "dest": "127.0.0.1:1", "req": {"url": "/x"}}
        )


def test_keys_diverged_through_full_retry_path(cluster):
    """Divergent keys abort at the retry re-lookup inside proxy_req, not
    just in _relookup directly (send.js:91-104)."""
    c = cluster(n=3)
    sender = c.node(0)
    k1 = key_owned_by(c, c.node(1), tag="fd1")
    k2 = key_owned_by(c, c.node(2), tag="fd2")
    sender.request_proxy.retry_schedule_s = [0.0]
    with pytest.raises(errors.KeysDivergedError) as ei:
        sender.proxy_req(
            {
                "keys": [k1, k2],
                "dest": "127.0.0.1:1",  # first attempt fails -> re-lookup
                "req": {"url": "/x"},
            }
        )
    assert sorted(ei.value.fields["keys"]) == sorted([k1, k2])


def test_forwarded_head_fidelity(cluster):
    """The routing envelope carries url, method, headers, httpVersion,
    the sender's checksum, and the keys (util.js:22-35)."""
    c = cluster(n=2)
    sender, dest = c.node(0), c.node(1)
    key = key_owned_by(c, dest, tag="hf")
    seen = {}

    def handler(req, res, head):
        seen.update(head)
        res.end({"ok": True})

    dest.on("request", handler)
    sender.proxy_req(
        {
            "keys": [key],
            "dest": dest.whoami(),
            "req": {
                "url": "/fidelity?q=1",
                "method": "PUT",
                "headers": {"x-app": "v"},
                "httpVersion": "1.0",
            },
        }
    )
    assert seen["url"] == "/fidelity?q=1"
    assert seen["method"] == "PUT"
    assert seen["headers"] == {"x-app": "v"}
    assert seen["httpVersion"] == "1.0"
    assert seen["ringpopKeys"] == [key]
    assert seen["ringpopChecksum"] == sender.membership.checksum


def test_channel_destroy_mid_retry_aborts_forwarding(cluster):
    """The real reference path: the CHANNEL dying mid-retry (ringpop
    destroyed / channel.quit()) aborts the forward instead of burning the
    whole retry schedule against a dead channel (send.js:228-234)."""
    c = cluster(n=2)
    sender = c.node(0)
    sender.request_proxy.retry_schedule_s = [0.0]
    remote = c.node(1).whoami()

    def destroy_ringpop_then_relookup(keys, dest):
        sender.destroy()  # destroys channel AND proxy, like production
        return remote

    sender.request_proxy._relookup = destroy_ringpop_then_relookup
    with pytest.raises(errors.RequestProxyDestroyedError):
        sender.proxy_req(
            {"keys": ["k"], "dest": "127.0.0.1:1", "req": {"url": "/x"}}
        )


def test_response_status_and_headers_propagate(cluster):
    """The remote handler's statusCode and headers ride back through the
    proxy envelope (request-proxy/index.js onResponse: responseHead)."""
    c = cluster(n=2)
    sender, dest = c.node(0), c.node(1)
    key = key_owned_by(c, dest, tag="rs")

    def handler(req, res, head):
        res.end({"made": "it"}, status=201, headers={"x-served": "yes"})

    dest.on("request", handler)
    res = sender.proxy_req(
        {"keys": [key], "dest": dest.whoami(), "req": {"url": "/s"}}
    )
    assert res["statusCode"] == 201
    assert res["headers"] == {"x-served": "yes"}
    assert res["body"] == {"made": "it"}


def test_handle_or_proxy_all_partial_failure(cluster):
    """One dead owner must not poison the other groups: its entry carries
    `error`, the rest carry `res` (index.js:609-667 per-group callbacks)."""
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, healthy, doomed = c.node(0), c.node(1), c.node(2)
    k_ok = key_owned_by(c, healthy, tag="pf-ok")
    k_bad = key_owned_by(c, doomed, tag="pf-bad")
    sender.request_proxy.retry_schedule_s = [0.0]
    doomed.destroy()  # owner is gone; ring on sender still maps to it
    results = sender.handle_or_proxy_all([k_ok, k_bad], {"url": "/pf"})
    by_dest = {r["dest"]: r for r in results}
    ok = by_dest[healthy.whoami()]
    assert ok["res"]["body"]["handledBy"] == healthy.whoami()
    bad = by_dest[doomed.whoami()]
    assert "error" in bad and "res" not in bad


def test_proxy_endpoint_override(cluster):
    """opts.endpoint replaces /proxy/req (send.js channelOpts.endpoint) —
    e.g. routing to a custom registered handler."""
    c = cluster(n=2)
    sender, dest = c.node(0), c.node(1)
    key = key_owned_by(c, dest, tag="ep")
    seen = {}

    def custom(head, body):
        seen["head"] = head
        return None, {"via": "custom"}

    dest.channel.register("/custom/endpoint", custom)
    res = sender.proxy_req(
        {
            "keys": [key],
            "dest": dest.whoami(),
            "req": {"url": "/x"},
            "endpoint": "/custom/endpoint",
        }
    )
    # a custom endpoint's handler answers with its raw body (the
    # {statusCode, headers, body} envelope is built by /proxy/req's own
    # handler, not the channel)
    assert res == {"via": "custom"}
    assert seen["head"]["ringpopKeys"] == [key]


def test_enforce_consistency_false_serves_despite_mismatch(cluster):
    """enforceConsistency=false: a checksum mismatch still increments the
    differ stat but the request IS served (proxy-test.js 'no retries,
    invalid checksum emit request when enforceConsistency is false';
    lib/request-proxy/index.js:186-193)."""
    c = cluster(n=2, options={"requestProxy": {"enforceConsistency": False}})
    wire_echo_handlers(c)
    from ringpop_tpu_torch.utils.stats import CapturingStatsd

    sender, dest = c.node(0), c.node(1)
    dest.statsd = CapturingStatsd()
    key = key_owned_by(c, dest)
    # destabilize dest's checksum: sender's head now carries a stale one
    dest.membership.update(
        {
            "address": "127.0.0.1:19996",
            "status": "faulty",
            "incarnationNumber": 1,
            "source": dest.whoami(),
            "sourceIncarnationNumber": 1,
        }
    )
    res = sender.proxy_req(
        {"keys": [key], "dest": dest.whoami(), "req": {"url": "/ec"}}
    )
    assert res["body"]["handledBy"] == dest.whoami()
    assert any(
        "checksumsDiffer" in k
        for _, k, _ in dest.statsd.records
    ), "the differ stat must fire even when not enforcing"


def test_per_retry_stats_full_lifecycle(cluster):
    """Per-retry stat emission (send.js:92-200): attempted on each retry,
    reroute.remote on re-lookup to another node, succeeded when a retry
    lands, and send.success exactly once for the whole request."""
    c = cluster(n=3)
    wire_echo_handlers(c)
    from ringpop_tpu_torch.utils.stats import CapturingStatsd

    sender, owner = c.node(0), c.node(1)
    sender.statsd = CapturingStatsd()
    sender.request_proxy.retry_schedule_s = [0.0]
    key = key_owned_by(c, owner)

    def count(fragment):
        return sum(
            1 for _, k, _ in sender.statsd.records if fragment in k
        )

    res = sender.proxy_req(
        {"keys": [key], "dest": "127.0.0.1:1", "req": {"url": "/st"}}
    )
    assert res["body"]["handledBy"] == owner.whoami()
    assert count("requestProxy.retry.attempted") == 1
    assert count("requestProxy.retry.reroute.remote") == 1
    assert count("requestProxy.retry.succeeded") == 1
    assert count("requestProxy.send.success") == 1
    assert count("requestProxy.retry.failed") == 0


def test_reroute_local_serves_in_process(cluster):
    """A retry whose re-lookup lands on the SENDER handles the request
    in-process and emits reroute.local (send.js:190-198, proxy-test.js
    'reroutes retry to local')."""
    c = cluster(n=2)
    wire_echo_handlers(c)
    from ringpop_tpu_torch.utils.stats import CapturingStatsd

    sender = c.node(0)
    sender.statsd = CapturingStatsd()
    sender.request_proxy.retry_schedule_s = [0.0]
    key = key_owned_by(c, sender)
    res = sender.proxy_req(
        {"keys": [key], "dest": "127.0.0.1:1", "req": {"url": "/lo"}}
    )
    assert res["body"]["handledBy"] == sender.whoami()
    assert any(
        "retry.reroute.local" in k for _, k, _ in sender.statsd.records
    )


def test_retries_multiple_keys_same_dest(cluster):
    """Multiple keys that re-lookup to ONE owner retry fine — divergence
    aborts only when owners differ (proxy-test.js 'retries multiple keys
    w/ same dest')."""
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, owner = c.node(0), c.node(1)
    sender.request_proxy.retry_schedule_s = [0.0]
    k1 = key_owned_by(c, owner, tag="mk1")
    k2 = key_owned_by(c, owner, tag="mk2")
    res = sender.proxy_req(
        {"keys": [k1, k2], "dest": "127.0.0.1:1", "req": {"url": "/mk"}}
    )
    assert res["body"]["handledBy"] == owner.whoami()
    assert res["body"]["keys"] == [k1, k2]


def test_proxies_big_json(cluster):
    """A ~1 MB JSON body survives the round trip intact (proxy-test.js
    'proxies big json')."""
    c = cluster(n=2)
    sender, dest = c.node(0), c.node(1)
    got = {}

    def handler(req, res, head):
        got["body"] = req["body"]
        res.end({"n": len(req["body"]["blob"])})

    dest.on("request", handler)
    key = key_owned_by(c, dest)
    blob = "x" * (1 << 20)
    res = sender.proxy_req(
        {
            "keys": [key],
            "dest": dest.whoami(),
            "req": {"url": "/big", "body": {"blob": blob}},
        }
    )
    assert res["body"]["n"] == len(blob)
    assert got["body"]["blob"] == blob


def test_custom_timeout_expires_against_stuck_handler(cluster):
    """A per-request timeout bounds a handler that never responds
    (proxy-test.js 'will timeout after default timeout' / 'custom
    timeouts'), surfacing as retry exhaustion."""
    c = cluster(n=2)
    sender, dest = c.node(0), c.node(1)

    def never_responds(req, res, head):
        pass  # res.end never called

    dest.on("request", never_responds)
    key = key_owned_by(c, dest)
    t0 = __import__("time").perf_counter()
    with pytest.raises(errors.MaxRetriesExceededError):
        sender.proxy_req(
            {
                "keys": [key],
                "dest": dest.whoami(),
                "req": {"url": "/slow"},
                "timeout": 300,  # ms
                "maxRetries": 0,
            }
        )
    assert __import__("time").perf_counter() - t0 < 10.0


def test_two_retries_then_success(cluster):
    """proxy-test.js:202-248 'two retries': two channel-level failures,
    then the third attempt lands; attempt accounting matches."""
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, dest = c.node(0), c.node(1)
    key = key_owned_by(c, dest)

    fails = {"left": 2}
    orig = sender.channel.request

    def flaky(dest_hp, endpoint, head=None, body=None, **kw):
        if endpoint == "/proxy/req" and fails["left"] > 0:
            fails["left"] -= 1
            from ringpop_tpu_torch.net.channel import ChannelError

            raise ChannelError("injected send failure", "test.flaky")
        return orig(dest_hp, endpoint, head=head, body=body, **kw)

    sender.channel.request = flaky
    before = _stat_count(sender, "requestProxy.retry.attempted")
    res = sender.proxy_req(
        {"keys": [key], "dest": dest.whoami(), "req": {"url": "/2r"}}
    )
    assert res["body"]["handledBy"] == dest.whoami()
    assert _stat_count(sender, "requestProxy.retry.attempted") - before == 2
    assert _stat_count(sender, "requestProxy.retry.succeeded") >= 1


def test_destroy_aborts_pending_send_completed_one_unaffected(cluster):
    """proxy-test.js:405-442 'cleans up some pending sends': with one
    request already completed and another still pending, destroy aborts
    only the pending one; the completed result is untouched."""
    import threading

    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, healthy, stuck = c.node(0), c.node(1), c.node(2)
    key_ok = key_owned_by(c, healthy, tag="ok")
    key_stuck = key_owned_by(c, stuck, tag="stuck")

    release = threading.Event()

    def stuck_handler(req, res, head):
        release.wait(10.0)
        res.end({"handledBy": stuck.whoami()})

    stuck.remove_all_listeners("request")
    stuck.on("request", stuck_handler)

    outcome = {}

    def pending():
        try:
            outcome["res"] = sender.proxy_req(
                {
                    "keys": [key_stuck],
                    "dest": stuck.whoami(),
                    "req": {"url": "/pending"},
                    "timeout": 500,  # ms: expire fast, then hit the
                    # destroyed check at the retry-loop top
                }
            )
        except Exception as e:
            outcome["err"] = e

    t = threading.Thread(target=pending, daemon=True)
    t.start()

    done = sender.proxy_req(
        {"keys": [key_ok], "dest": healthy.whoami(), "req": {"url": "/done"}}
    )
    assert done["body"]["handledBy"] == healthy.whoami()

    sender.request_proxy.destroy()
    # do NOT release yet: the pending attempt must expire on its own
    # timeout and then hit the destroyed check at the retry-loop top
    t.join(15.0)
    release.set()  # free the handler thread for teardown
    assert not t.is_alive(), "pending send did not unwind after destroy"
    assert isinstance(outcome.get("err"), errors.RequestProxyDestroyedError)
    # the completed request's result is unaffected by the destroy
    assert done["body"]["handledBy"] == healthy.whoami()


def test_proxy_endpoint_override_to_missing_endpoint_fails(cluster):
    """proxy-test.js:485-513 'overrides /proxy/req endpoint and fails':
    an override pointing at an unregistered endpoint errors out (a
    non-checksum remote error does not retry)."""
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, dest = c.node(0), c.node(1)
    key = key_owned_by(c, dest)
    from ringpop_tpu_torch.net.channel import ChannelError, RemoteError

    with pytest.raises((ChannelError, RemoteError)):
        sender.proxy_req(
            {
                "keys": [key],
                "dest": dest.whoami(),
                "req": {"url": "/x"},
                "endpoint": "/no/such/endpoint",
            }
        )
    assert _stat_count(sender, "requestProxy.send.error") >= 1


def test_missing_head_fields_handled(cluster):
    """Nearest analog of proxy-test.js:932-955 'non json head is ok' for
    a JSON-typed transport: a /proxy/req with missing head fields (no
    checksum, no keys) is handled without crashing — the checksum
    mismatch path rejects it cleanly under enforceConsistency."""
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, dest = c.node(0), c.node(1)
    from ringpop_tpu_torch.net.channel import RemoteError

    with pytest.raises(RemoteError) as ei:
        sender.channel.request(
            dest.whoami(), "/proxy/req", head={"url": "/bare"}, body=None,
            timeout_s=5,
        )
    assert "checksum" in str(ei.value.payload).lower()


def test_send_on_destroyed_channel_refused_up_front(cluster):
    """proxy-test.js:1043-1065 'send on destroyed channel not allowed':
    a proxy_req AFTER the channel is destroyed refuses before any
    forwarding attempt (send.js:228-234)."""
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender, dest = c.node(0), c.node(1)
    key = key_owned_by(c, dest)
    sender.channel.destroyed = True
    try:
        before = _stat_count(sender, "requestProxy.retry.attempted")
        with pytest.raises(errors.RequestProxyDestroyedError):
            sender.proxy_req(
                {"keys": [key], "dest": dest.whoami(), "req": {"url": "/x"}}
            )
        assert _stat_count(sender, "requestProxy.retry.attempted") == before
    finally:
        sender.channel.destroyed = False


# -- retry accounting closure (ISSUE 6 satellite) ---------------------------
# The routing plane's device counters (models/route/plane.RouteMetrics)
# mirror these statsd keys one-to-one (obs/statsd_bridge.py); the tests
# below pin the per-request accounting the aggregate counters must match:
# send.js:91-208 client semantics, request-proxy/index.js:168-229 server.


def _counts(rp, *suffixes):
    return {s: _stat_count(rp, "requestProxy.%s" % s) for s in suffixes}


def test_keys_diverged_abort_closes_retry_aborted_and_send_error(cluster):
    """A keys-diverged abort on the retry re-lookup closes the request's
    accounting: retry.aborted + send.error fire exactly once, and NO
    success stat fires (send.js:91-104 — the request fails permanently,
    it is not rerouted)."""
    c = cluster(n=3)
    wire_echo_handlers(c)
    sender = c.node(0)
    sender.request_proxy.retry_schedule_s = [0.0]
    k1 = key_owned_by(c, c.node(1), tag="acc1")
    k2 = key_owned_by(c, c.node(2), tag="acc2")
    before = _counts(
        sender,
        "retry.attempted", "retry.aborted", "retry.succeeded",
        "send.error", "send.success",
    )
    # first attempt targets a dead address -> ChannelError -> retry path
    # re-looks up BOTH keys, finds two owners, aborts
    with pytest.raises(errors.KeysDivergedError):
        sender.proxy_req(
            {"keys": [k1, k2], "dest": "127.0.0.1:1", "req": {"url": "/d"}}
        )
    after = _counts(
        sender,
        "retry.attempted", "retry.aborted", "retry.succeeded",
        "send.error", "send.success",
    )
    delta = {k: after[k] - before[k] for k in after}
    assert delta["retry.attempted"] == 1
    assert delta["retry.aborted"] == 1
    assert delta["send.error"] == 1
    assert delta["retry.succeeded"] == 0
    assert delta["send.success"] == 0


def test_reroute_local_fires_full_success_accounting(cluster):
    """A retry rerouted to the SENDER serves in-process AND fires the
    complete success accounting — reroute.local, retry.succeeded and
    send.success — exactly like a remote landing (send.js:190-198); no
    error stat leaks."""
    c = cluster(n=2)
    wire_echo_handlers(c)
    sender = c.node(0)
    sender.request_proxy.retry_schedule_s = [0.0]
    key = key_owned_by(c, sender, tag="accl")
    before = _counts(
        sender,
        "retry.attempted", "retry.reroute.local", "retry.succeeded",
        "send.success", "send.error", "retry.aborted",
    )
    res = sender.proxy_req(
        {"keys": [key], "dest": "127.0.0.1:1", "req": {"url": "/l"}}
    )
    assert res["body"]["handledBy"] == sender.whoami()
    after = _counts(
        sender,
        "retry.attempted", "retry.reroute.local", "retry.succeeded",
        "send.success", "send.error", "retry.aborted",
    )
    delta = {k: after[k] - before[k] for k in after}
    assert delta["retry.attempted"] == 1
    assert delta["retry.reroute.local"] == 1
    assert delta["retry.succeeded"] == 1
    assert delta["send.success"] == 1
    assert delta["send.error"] == 0
    assert delta["retry.aborted"] == 0


def test_destroyed_channel_mid_retry_aborts_without_success_stats(cluster):
    """A channel destroyed between attempts aborts the in-flight retry
    (send.js:228-234) with NO success accounting and no further retry
    attempts — the abort happens at the pre-attempt destroyed check,
    before any forwarding."""
    c = cluster(n=2)
    sender = c.node(0)
    sender.request_proxy.retry_schedule_s = [0.0]
    remote = c.node(1).whoami()

    def destroy_channel_then_relookup(keys, dest):
        sender.channel.destroyed = True
        return remote

    sender.request_proxy._relookup = destroy_channel_then_relookup
    before = _counts(
        sender, "retry.attempted", "retry.succeeded", "send.success"
    )
    try:
        with pytest.raises(errors.RequestProxyDestroyedError):
            sender.proxy_req(
                {"keys": ["k"], "dest": "127.0.0.1:1", "req": {"url": "/x"}}
            )
        after = _counts(
            sender, "retry.attempted", "retry.succeeded", "send.success"
        )
        assert after["retry.attempted"] - before["retry.attempted"] == 1
        assert after["retry.succeeded"] == before["retry.succeeded"]
        assert after["send.success"] == before["send.success"]
    finally:
        sender.channel.destroyed = False
