"""The port's bucketed incremental ring and Zipf traffic against the JAX
package, bit for bit.

The schedules are those of tests/models/test_route_ring.py: randomized
churn at n=64 (R=8, B=4) and a second geometry (n=37, R=12, B=2), each
tick's update run with caps large enough to stay incremental and with
caps small enough to force the full-rebuild fallback.  Every ``RingState``
field (the uint64 segment keys through the port's sign-flip convention),
the update's stats, the materialized ring (against the JAX ring and the
port's own ``build_ring``), ``lookup`` and ``lookup_n_fixed`` must equal the
JAX ones exactly (tolerance: none).  ``zipf_cdf`` is pinned bitwise at
the four (key_space, s) settings the gates use, with ``sample_keys`` and
``key_hashes`` on the same keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.ring import device as jrd
from ringpop_tpu.models.route import ring_kernel as jrk
from ringpop_tpu.models.route import traffic as jtr
from ringpop_tpu_torch.models.ring import device as prd
from ringpop_tpu_torch.models.route import ring_kernel as prk
from ringpop_tpu_torch.models.route import traffic as ptr
from ringpop_tpu_torch.ops import threefry, u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


# the JAX functions under jit: one compile per shape and caps, not one
# dispatch per op
_j_update = jax.jit(jrk.update, static_argnames=("max_changed", "max_dirty"))
_j_full_rebuild = jax.jit(jrk.full_rebuild)
_j_materialize = jax.jit(jrk.materialize, static_argnums=1)
_j_lookup = jax.jit(jrk.lookup)


def _buckets(n, r, bits):
    reps = np.asarray(jrd.device_replica_hashes(n, r))
    return jrk.build_buckets(reps, bits), prk.build_buckets(reps, bits), reps


def _assert_state_equal(j, p):
    assert np.array_equal(prd.ring_to_numpy(p.seg_keys).reshape(j.seg_keys.shape),
                          np.asarray(j.seg_keys))
    for f in ("count", "mask", "n_points", "first_owner", "next_owner"):
        a, b = np.asarray(getattr(j, f)), getattr(p, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f


def test_build_buckets_equal_jax():
    for n, r, bits in ((64, 8, 4), (37, 12, 2), (1000, 16, 6)):
        jb, pb, reps = _buckets(n, r, bits)
        assert np.array_equal(prd.ring_to_numpy(pb.keys).reshape(jb.keys.shape),
                              np.asarray(jb.keys))
        assert np.array_equal(pb.owners.numpy(), np.asarray(jb.owners))
        assert np.array_equal(pb.point_bucket.numpy(), np.asarray(jb.point_bucket))
        # the PAD keys, computed in uint64 on the host; the last one wraps
        # to 2^64 - 1
        pads = prd.ring_to_numpy(pb.pads)
        assert pads[-1] == np.uint64(2**64 - 1)
        assert np.array_equal(pads, ((np.arange(1 << bits, dtype=np.uint64) + np.uint64(1))
                                     << np.uint64(64 - bits)) - np.uint64(1))
        # the port's int32 view of the same table gives the same buckets
        pb2 = prk.build_buckets(u32.from_numpy(reps), bits)
        assert all(torch.equal(a, b) for a, b in zip(pb, pb2))


@pytest.mark.parametrize("n,r,bits,ticks,flips_hi,seed",
                         [(64, 8, 4, 25, 5, 0), (37, 12, 2, 15, 4, 7)])
def test_update_equals_jax_under_randomized_churn(n, r, bits, ticks, flips_hi, seed):
    jb, pb, reps = _buckets(n, r, bits)
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.8
    js = _j_full_rebuild(jb, jnp.asarray(mask))
    ps = prk.full_rebuild(pb, torch.as_tensor(mask))
    _assert_state_equal(js, ps)
    fallbacks = 0
    for t in range(ticks):
        flips = rng.choice(n, size=int(rng.integers(0, flips_hi)), replace=False)
        mask = mask.copy()
        mask[flips] = ~mask[flips]
        jm, pm = jnp.asarray(mask), torch.as_tensor(mask)
        # roomy caps (incremental), then caps the churn overflows
        for caps in (dict(max_changed=max(8, flips_hi), max_dirty=1 << bits),
                     dict(max_changed=2, max_dirty=3)):
            jout = _j_update(jb, js, jm, **caps)
            pout = prk.update(pb, ps, pm, **caps)
            _assert_state_equal(jout[0], pout[0])
            _assert_state_equal(jout[0], prk.full_rebuild(pb, pm))
            for a, b in zip(jout[1:], pout[1:]):
                assert b.dtype == torch.int32 and int(a) == int(b), (t, caps)
            fallbacks += int(pout[3])
        js, ps = jout[0], pout[0]
        flat = prk.materialize(ps, n * r)
        assert torch.equal(flat, prd.build_ring(u32.from_numpy(reps), pm))
        assert np.array_equal(prd.ring_to_numpy(flat), np.asarray(_j_materialize(js, n * r)))
        keys = rng.integers(0, 2**32, size=300, dtype=np.uint32)
        assert np.array_equal(prk.lookup(ps, u32.from_numpy(keys)).numpy(),
                              np.asarray(_j_lookup(js, jnp.asarray(keys)))), t
    assert fallbacks > 0


def test_overflow_falls_back_like_jax():
    jb, pb, reps = _buckets(48, 8, 3)
    rng = np.random.default_rng(3)
    mask = rng.random(48) < 0.9
    js = _j_full_rebuild(jb, jnp.asarray(mask))
    ps = prk.full_rebuild(pb, torch.as_tensor(mask))
    jout = _j_update(jb, js, jnp.asarray(~mask), max_changed=4, max_dirty=4)
    pout = prk.update(pb, ps, torch.as_tensor(~mask), max_changed=4, max_dirty=4)
    assert [int(x) for x in pout[1:]] == [int(x) for x in jout[1:]]
    assert int(pout[3]) == 1 and int(pout[1]) == 48
    _assert_state_equal(jout[0], pout[0])


def test_lookup_matches_jax_and_flat_ring():
    jb, pb, reps = _buckets(64, 8, 4)
    rng = np.random.default_rng(5)
    for _ in range(4):
        mask = rng.random(64) < rng.uniform(0.2, 0.95)
        ps = prk.full_rebuild(pb, torch.as_tensor(mask))
        keys = rng.integers(0, 2**32, size=512, dtype=np.uint32)
        # exact replica-point hits too (the lower-bound semantics)
        keys[:64] = reps.reshape(-1)[:64]
        got = prk.lookup(ps, u32.from_numpy(keys)).numpy()
        want = np.asarray(_j_lookup(_j_full_rebuild(jb, jnp.asarray(mask)), jnp.asarray(keys)))
        assert np.array_equal(got, want)
        pm = torch.as_tensor(mask)
        ring = prd.build_ring(u32.from_numpy(reps), pm)
        flat = prd.lookup(ring, prd.ring_size(pm, 8), u32.from_numpy(keys)).numpy()
        assert np.array_equal(got, flat)


def test_empty_and_single_server_ring():
    jb, pb, _ = _buckets(16, 4, 2)
    keys = np.arange(8, dtype=np.uint32) * np.uint32(0x1234567)
    empty = prk.full_rebuild(pb, torch.zeros(16, dtype=torch.bool))
    _assert_state_equal(_j_full_rebuild(jb, jnp.zeros(16, bool)), empty)
    assert (prk.lookup(empty, u32.from_numpy(keys)) == -1).all()
    assert int(empty.first_owner) == -1 and (empty.next_owner == -1).all()
    one = torch.zeros(16, dtype=torch.bool)
    one[5] = True
    single = prk.full_rebuild(pb, one)
    _assert_state_equal(_j_full_rebuild(jb, jnp.zeros(16, bool).at[5].set(True)), single)
    assert (prk.lookup(single, u32.from_numpy(keys)) == 5).all()
    flat = prk.materialize(empty, 64)
    assert np.array_equal(prd.ring_to_numpy(flat), np.full(64, prk.SENTINEL))


@pytest.mark.parametrize("width_kind", ["whole_ring", "short"])
def test_lookup_n_fixed_equals_jax(width_kind):
    jb, pb, reps = _buckets(24, 8, 3)
    rng = np.random.default_rng(9)
    for _ in range(3):
        mask = rng.random(24) < 0.7
        jm, pm = jnp.asarray(mask), torch.as_tensor(mask)
        jring, jn = jrd.build_ring(jnp.asarray(reps), jm), jrd.ring_size(jm, 8)
        pring = prk.materialize(prk.full_rebuild(pb, pm), 24 * 8)
        pn = prd.ring_size(pm, 8)
        width = int(jn) if width_kind == "whole_ring" else 6
        keys = rng.integers(0, 2**32, size=40, dtype=np.uint32)
        jo, jf = jax.vmap(lambda k: jrk.lookup_n_fixed(jring, jn, k, 3, width=width))(
            jnp.asarray(keys))
        po, pf = prk.lookup_n_fixed(pring, pn, u32.from_numpy(keys), 3, width=width)
        assert po.dtype == torch.int32 and np.array_equal(po.numpy(), np.asarray(jo))
        assert np.array_equal(pf.numpy(), np.asarray(jf))
        # one scalar key, unbatched
        so, sf = prk.lookup_n_fixed(pring, pn, u32.from_numpy(keys[:1])[0], 3, width=width)
        assert np.array_equal(so.numpy(), np.asarray(jo[0])) and int(sf) == int(jf[0])
        if width_kind == "whole_ring":
            walk = prd.lookup_n(pring, pn, u32.from_numpy(keys[:1])[0], 3)
            assert torch.equal(walk, so)


def test_lookup_n_fixed_empty_ring():
    _, pb, _ = _buckets(8, 4, 2)
    ring = prk.materialize(prk.full_rebuild(pb, torch.zeros(8, dtype=torch.bool)), 32)
    owners, found = prk.lookup_n_fixed(ring, torch.tensor(0, dtype=torch.int32),
                                       u32.from_numpy(np.array([123], np.uint32))[0], 3, width=8)
    assert (owners == -1).all() and int(found) == 0


def test_bucket_bits_validation_and_defaults():
    reps = np.asarray(jrd.device_replica_hashes(8, 2))
    for bits in (0, 21):
        with pytest.raises(ValueError):
            prk.build_buckets(reps, bits)
    for n, r in ((64, 8), (1000, 16), (100_000, 16), (1_000_000, 16)):
        assert prk.default_bucket_bits(n, r) == jrk.default_bucket_bits(n, r)


@pytest.mark.parametrize("k,s", [(65536, 1.1), (1024, 1.1), (65536, 0.8), (1 << 20, 1.1)])
def test_zipf_cdf_bitwise(k, s):
    want = np.asarray(jtr.zipf_cdf(k, s))
    got = ptr.zipf_cdf(k, s).numpy()
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_sample_keys_and_key_hashes_equal_jax():
    for k, s in ((1024, 1.1), (65536, 0.8)):
        jcdf, pcdf = jtr.zipf_cdf(k, s), ptr.zipf_cdf(k, s)
        for seed in range(4):
            jk, pk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
            jids, pids = jtr.sample_keys(jk, jcdf, 4096), ptr.sample_keys(pk, pcdf, 4096)
            assert pids.dtype == torch.int32 and np.array_equal(pids.numpy(), np.asarray(jids))
            assert np.array_equal(u32.to_numpy(ptr.key_hashes(pids)),
                                  np.asarray(jtr.key_hashes(jids)))
