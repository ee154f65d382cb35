"""The port's host ring (``models/ring/host.py``, hashed through the port's
native FarmHash): the host cases of tests/models/test_ring.py on the
port's ``HashRing``; the port's ``HashRing`` against the JAX package's on
lookups, ``lookup_n``, checksums and point tables under churn; and
against the port's device ring (``models/ring/device.py``) on lookups and
``lookup_n``.  Equality is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.models.ring import HashRing as JaxHashRing
from ringpop_tpu_torch.models.ring import device as dring
from ringpop_tpu_torch.models.ring import HashRing
from ringpop_tpu_torch.ops import farmhash32 as fh
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


# ---- the host cases of tests/models/test_ring.py ----


def create_servers(n):
    return ["127.0.0.1:%d" % (3000 + i) for i in range(n)]


def extract_port(server: str) -> int:
    # the reference's deterministic stub hashFunc (ring-test.js:32-34)
    return int(str(server)[str(server).rindex(":") + 1 :])


SERVERS = create_servers(200)


def test_server_count_add_remove():
    ring = HashRing()
    ring.add_remove_servers(SERVERS, None)
    assert ring.get_server_count() == len(SERVERS)
    ring.add_remove_servers(None, SERVERS)
    assert ring.get_server_count() == 0
    ring.add_remove_servers(SERVERS, SERVERS)
    assert ring.get_server_count() == 0


def test_checksum_computed_once_per_bulk_change():
    ring = HashRing()
    count = []
    ring.on("checksumComputed", lambda *a: count.append(1))
    ring.add_remove_servers(SERVERS, SERVERS)
    assert len(count) == 1


def test_lookup_own_replica_point():
    # '1000 lookups' (ring-test.js:65-79): lookup(server + '0') lands exactly
    # on server's replica-0 point; the rbtree's upperBound is >= (lower bound)
    ring = HashRing()
    ring.add_remove_servers(SERVERS, None)
    for server in SERVERS:
        assert ring.lookup(server + "0") == server


def test_lookup_n_with_port_hash():
    # '1000 lookupN' (ring-test.js:81-100): with hashFunc=extractPort the
    # successors are the next servers by port
    servers = SERVERS[:50]
    ring = HashRing(hash_func=extract_port)
    ring.add_remove_servers(servers, None)
    for i, server in enumerate(servers):
        expect = [
            servers[i],
            servers[(i + 1) % len(servers)],
            servers[(i + 2) % len(servers)],
        ]
        assert ring.lookup_n(server + "0", 3) == expect


def test_lookup_n_small_and_empty_ring():
    ring = HashRing(hash_func=extract_port)
    server = SERVERS[0]
    ring.add_remove_servers([server], None)
    assert ring.lookup_n(server + "0", 3) == [server]

    empty = HashRing(hash_func=extract_port)
    assert empty.lookup_n(server + "0", 3) == []


def test_lookup_n_corrupted_ring():
    # serverCount out of sync with the point table must not loop forever
    ring = HashRing(hash_func=extract_port)
    ring.add_remove_servers([SERVERS[0]], None)
    ring.servers[SERVERS[1]] = True  # corrupt: claims 2 servers, tree has 1
    assert ring.lookup_n(SERVERS[0] + "0", 3) == [SERVERS[0]]

    empty = HashRing(hash_func=extract_port)
    empty.servers[SERVERS[0]] = True
    assert empty.lookup_n(SERVERS[0] + "0", 3) == []


def test_checksum_lifecycle():
    ring = HashRing()
    assert ring.checksum is None
    ring.add_server(SERVERS[0])
    first = ring.checksum
    assert first is not None
    ring.remove_server("127.0.0.1:9999")  # non-existent: no recompute
    assert ring.checksum == first
    ring.add_server(SERVERS[1])
    assert ring.checksum != first
    ring.remove_server(SERVERS[1])
    assert ring.checksum == first


def test_checksum_order_independent():
    a = HashRing()
    b = HashRing()
    for s in SERVERS[:10]:
        a.add_server(s)
    for s in reversed(SERVERS[:10]):
        b.add_server(s)
    assert a.checksum == b.checksum
    # checksum equals hash32 of sorted names joined ';'
    assert a.checksum == fh.hash32(";".join(sorted(SERVERS[:10])))


def test_wraparound_past_max_hash():
    ring = HashRing()
    ring.add_remove_servers(SERVERS[:8], None)
    hashes, owners = ring.table()
    # a key hashing beyond the max ring point must wrap to the ring minimum
    max_hash = int(hashes.max())
    # find a key whose hash exceeds every point (search a few candidates)
    key = None
    for i in range(100000):
        cand = "wrap-%d" % i
        if fh.hash32(cand) > max_hash:
            key = cand
            break
    if key is None:
        pytest.skip("no key found beyond max point hash")
    min_owner = owners[int(np.argmin(hashes))]
    assert ring.lookup(key) == min_owner


# ---- the port's HashRing against the JAX package's ----


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_ring_equals_jax_under_churn(seed):
    rng = np.random.default_rng(seed)
    universe = create_servers(40) + ["10.1.2.%d:%d" % (i, 4000 + i) for i in range(20)]
    port, ref = HashRing(), JaxHashRing()
    keys = ["key-%d" % i for i in range(200)] + [s + "0" for s in universe[:10]]
    for step in range(12):
        add = [universe[int(i)] for i in rng.choice(len(universe), 8, replace=False)]
        rem = [universe[int(i)] for i in rng.choice(len(universe), 5, replace=False)]
        assert port.add_remove_servers(add, rem) == ref.add_remove_servers(add, rem)
        assert port.checksum == ref.checksum, step
        assert port.get_server_count() == ref.get_server_count()
        ph, po = port.table()
        jh, jo = ref.table()
        np.testing.assert_array_equal(ph, jh)
        assert list(po) == list(jo)
        assert [port.lookup(k) for k in keys] == [ref.lookup(k) for k in keys], step
        for k in keys[::20]:
            for n in (1, 3, 7):
                assert port.lookup_n(k, n) == ref.lookup_n(k, n), (step, k, n)


# ---- the port's HashRing against the port's device ring ----


def _device_ring(universe, mask):
    table = u32.from_numpy(dring.replica_table(universe, replica_points=100))
    m = torch.as_tensor(np.asarray(mask, bool))
    return dring.build_ring(table, m), dring.ring_size(m, 100)


def _key(k):
    return torch.tensor(u32.s32(fh.hash32(k)), dtype=torch.int32)


def test_device_ring_matches_host():
    servers = create_servers(32)
    universe = sorted(servers)
    host = HashRing()
    host.add_remove_servers(servers, None)
    ring, n_points = _device_ring(universe, [True] * len(universe))
    keys = ["key-%d" % i for i in range(300)]
    hashes = torch.as_tensor(fh.hash32_strings(keys).view(np.int32))
    owners = dring.lookup(ring, n_points, hashes).numpy()
    for k, o in zip(keys, owners):
        assert universe[int(o)] == host.lookup(k), k


def test_device_ring_masked_rebuild_matches_host_subset():
    universe = sorted(create_servers(24))
    mask = [i % 3 != 0 for i in range(len(universe))]
    host = HashRing()
    host.add_remove_servers([s for s, m in zip(universe, mask) if m], None)
    ring, n_points = _device_ring(universe, mask)
    for k in ["alpha", "beta", "gamma", "host:123", "127.0.0.1:30001"]:
        assert universe[int(dring.lookup(ring, n_points, _key(k)))] == host.lookup(k), k


@pytest.mark.parametrize("n", [1, 4, 9])
def test_device_lookup_n_matches_host(n):
    servers = create_servers(16)
    universe = sorted(servers)
    host = HashRing()
    host.add_remove_servers(servers, None)
    ring, n_points = _device_ring(universe, [True] * len(universe))
    for k in ["a", "bb", "ccc", "127.0.0.1:3005"] + ["k%d" % i for i in range(20)]:
        got = [universe[int(g)] for g in dring.lookup_n(ring, n_points, _key(k), n) if g >= 0]
        assert got == host.lookup_n(k, n), k


def test_device_empty_ring_and_host_empty_ring():
    ring, n_points = _device_ring(["127.0.0.1:3000"], [False])
    assert int(dring.lookup(ring, n_points, _key("x"))) == -1
    assert all(int(x) == -1 for x in dring.lookup_n(ring, n_points, _key("x"), 3))
    empty = HashRing()
    assert empty.lookup("x") is None and empty.lookup_n("x", 3) == []
