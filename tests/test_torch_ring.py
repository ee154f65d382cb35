"""The port's device ring against ``ringpop_tpu.models.ring.device``.

The ring holds uint64 keys ``(hash << 32) | owner``; the port stores them
sign-flipped as int64 so that torch's signed sort gives the unsigned
order.  Random replica hashes cover both sides of 2^31, so a missing flip
would reorder the ring.  Every result is compared bit for bit: the
unflipped key table, its checksum, ``lookup`` and ``lookup_n``, on random
masks and on an empty ring.  Also the int64 branch of ``record_mix``,
which hashes the high word of a 64-bit incarnation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.ring import device as jring
from ringpop_tpu.ops.record_mix import record_mix as j_record_mix
from ringpop_tpu_torch.models.ring import device as pring
from ringpop_tpu_torch.ops import u32
from ringpop_tpu_torch.ops.record_mix import record_mix as p_record_mix
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _hashes(n, r, seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, (n, r), dtype=np.uint64).astype(np.uint32)
    h[0, 0], h[-1, -1] = 0x7FFFFFFF, 0x80000000  # both sides of 2^31
    assert (h >= 2**31).any() and (h < 2**31).any()
    return h


def _rings(h, mask):
    jr = jring.build_ring(jnp.asarray(h), jnp.asarray(mask))
    pr = pring.build_ring(u32.from_numpy(h), torch.as_tensor(mask))
    return jr, pr


@pytest.mark.parametrize("n,r,p", [(24, 8, 0.6), (50, 16, 0.9), (7, 3, 0.2)])
def test_build_ring_and_checksum_equal_jax(n, r, p):
    h = _hashes(n, r, seed=n)
    mask = np.random.default_rng(n + 1).random(n) < p
    mask[0] = True
    jr, pr = _rings(h, mask)
    assert pr.dtype == torch.int64
    got = pring.ring_to_numpy(pr)
    assert np.array_equal(got, np.asarray(jr))
    assert (np.diff(got.astype(object)) >= 0).all()  # unsigned ascending
    assert int(u32.to_numpy(pring.ring_checksum(pr))) == int(jring.ring_checksum(jr))
    assert int(pring.ring_size(torch.as_tensor(mask), r)) == int(
        jring.ring_size(jnp.asarray(mask), r)
    )


def test_flip_orders_hashes_across_two_to_the_31():
    h = np.array([[0xFFFFFFFF, 0x80000000], [0x7FFFFFFF, 0x00000000]], np.uint32)
    pr = pring.build_ring(u32.from_numpy(h), torch.ones(2, dtype=torch.bool))
    keys = pring.ring_to_numpy(pr)
    assert [int(k >> np.uint64(32)) for k in keys] == [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    assert [int(k & np.uint64(0xFFFFFFFF)) for k in keys] == [1, 1, 0, 0]


def test_lookup_and_lookup_n_equal_jax():
    n, r = 40, 8
    h = _hashes(n, r, seed=3)
    mask = np.random.default_rng(4).random(n) < 0.5
    jr, pr = _rings(h, mask)
    pts = int(jring.ring_size(jnp.asarray(mask), r))
    keys = np.random.default_rng(5).integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    keys[:4] = (0, 0xFFFFFFFF, h[0, 0], h[1, 2])  # ends and exact hits
    want = np.asarray(jring.lookup(jr, jnp.int32(pts), jnp.asarray(keys)))
    got = pring.lookup(pr, torch.tensor(pts, dtype=torch.int32), u32.from_numpy(keys))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    for k in keys[:12]:
        for want_n in (1, 3, int(mask.sum()) + 2):
            w = np.asarray(jring.lookup_n(jr, jnp.int32(pts), jnp.uint32(k), want_n))
            g = pring.lookup_n(pr, torch.tensor(pts), u32.from_numpy(np.uint32(k)), want_n)
            assert np.array_equal(g.numpy(), w), (int(k), want_n)


def test_empty_ring_equals_jax():
    n, r = 6, 4
    h = _hashes(n, r, seed=9)
    mask = np.zeros(n, bool)
    jr, pr = _rings(h, mask)
    assert np.array_equal(pring.ring_to_numpy(pr), np.asarray(jr))
    assert (pring.ring_to_numpy(pr) == pring.SENTINEL).all()
    assert int(u32.to_numpy(pring.ring_checksum(pr))) == int(jring.ring_checksum(jr))
    zero = torch.tensor(0, dtype=torch.int32)
    keys = np.array([0, 5, 0xFFFFFFFF], np.uint32)
    assert (pring.lookup(pr, zero, u32.from_numpy(keys)).numpy() == -1).all()
    assert np.array_equal(
        pring.lookup(pr, zero, u32.from_numpy(keys)).numpy(),
        np.asarray(jring.lookup(jr, jnp.int32(0), jnp.asarray(keys))),
    )
    assert (pring.lookup_n(pr, zero, u32.from_numpy(np.uint32(5)), 3).numpy() == -1).all()


def test_device_replica_hashes_equal_jax():
    got = u32.to_numpy(pring.device_replica_hashes(100, 16))
    assert np.array_equal(got, np.asarray(jring.device_replica_hashes(100, 16)))


def test_replica_table_equals_jax():
    addrs = ["127.0.0.1:%d" % (3000 + i) for i in range(5)]
    assert np.array_equal(pring.replica_table(addrs, 7), jring.replica_table(addrs, 7))


@pytest.mark.parametrize("wide", [False, True])
def test_record_mix_int64_branch_equals_jax(wide):
    rng = np.random.default_rng(21)
    subj = rng.integers(0, 2**31, 512).astype(np.int32)
    status = rng.integers(0, 4, 512).astype(np.int32)
    if wide:
        inc = rng.integers(-(2**63), 2**63 - 1, 512, dtype=np.int64)
        inc[:3] = (0, -1, 0x5EED)
    else:
        inc = rng.integers(-(2**31), 2**31 - 1, 512).astype(np.int32)
    want = np.asarray(j_record_mix(jnp.asarray(subj), jnp.asarray(status), jnp.asarray(inc)))
    got = p_record_mix(torch.as_tensor(subj), torch.as_tensor(status), torch.as_tensor(inc))
    assert got.dtype == torch.int32
    assert np.array_equal(u32.to_numpy(got), want)
