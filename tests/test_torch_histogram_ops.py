"""The port's log2 histogram op against the JAX op, bit for bit.

``bucket_index`` is the exponent of ``torch.frexp`` in the port and a count
of 31 thresholds in JAX; both must give the same bucket at every edge value
(0, 1, 2^k - 1, 2^k, 2^30, 2^31 - 1 and negatives).  ``record`` must drop
the same lanes (masked, negative) and count duplicates alike, and the
counters must wrap mod 2^32 as the JAX uint32 counters do (the port keeps
them as int32 bit patterns).  Tolerance: none (integer counters).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.ops import histogram as jhg
from ringpop_tpu_torch.ops import histogram as phg
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _edges() -> np.ndarray:
    ks = np.arange(31, dtype=np.int64)
    vals = np.concatenate([
        [0, 1, 2, 3, 2**30, 2**31 - 1, -1, -2, -(2**31), -(2**30) - 7],
        2**ks, 2**ks - 1, 2**ks + 1,
    ])
    vals = vals[(vals >= -(2**31)) & (vals < 2**31)]
    return vals.astype(np.int32)


def _hist_np(h: torch.Tensor) -> np.ndarray:
    return u32.to_numpy(h)


def test_constants_and_bucket_bounds_equal_jax():
    assert phg.NBUCKETS == jhg.NBUCKETS
    for b in range(phg.NBUCKETS):
        assert (phg.bucket_lo(b), phg.bucket_hi(b)) == (jhg.bucket_lo(b), jhg.bucket_hi(b))
    v = _edges()
    assert np.array_equal(phg.bucket_index_np(np.maximum(v, 0)),
                          jhg.bucket_index_np(np.maximum(v, 0)))


def test_bucket_index_edges_equal_jax():
    v = _edges()
    got = phg.bucket_index(torch.as_tensor(v))
    assert got.dtype == torch.int32
    want = np.asarray(jhg.bucket_index(jnp.asarray(v)))
    assert np.array_equal(got.numpy(), want)
    # and the host oracle over the non-negative lanes
    nn = v >= 0
    assert np.array_equal(got.numpy()[nn], jhg.bucket_index_np(v[nn]))


def test_bucket_index_of_other_int_dtypes():
    v = np.array([0, 5, 1 << 20, 2**31 - 1], np.int64)
    assert np.array_equal(phg.bucket_index(torch.as_tensor(v)).numpy(),
                          phg.bucket_index(torch.as_tensor(v.astype(np.int32))).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_record_drops_and_duplicates_equal_jax(seed):
    rng = np.random.default_rng(seed)
    m = 4000
    # heavy duplicates in a few buckets, plus negatives and masked lanes
    vals = np.where(rng.random(m) < 0.5, rng.integers(-50, 50, m),
                    rng.integers(-(2**31), 2**31 - 1, m)).astype(np.int32)
    mask = rng.random(m) < 0.7
    jh = jhg.init(3)
    ph = phg.init(3)
    for track in (0, 2, 2):
        jh = jhg.record(jh, track, jnp.asarray(vals), jnp.asarray(mask))
        ph = phg.record(ph, track, torch.as_tensor(vals), torch.as_tensor(mask))
    assert ph.dtype == torch.int32 and ph.shape == (3, phg.NBUCKETS)
    assert np.array_equal(_hist_np(ph), np.asarray(jh))
    assert _hist_np(ph)[1].sum() == 0  # an untouched track stays zero


def test_record_shapes_flatten_row_major():
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 1000, (16, 16)).astype(np.int32)
    mask = rng.random((16, 16)) < 0.5
    jh = jhg.record(jhg.init(1), 0, jnp.asarray(vals), jnp.asarray(mask))
    ph = phg.record(phg.init(1), 0, torch.as_tensor(vals), torch.as_tensor(mask))
    assert np.array_equal(_hist_np(ph), np.asarray(jh))


def test_record_wraps_mod_2_32_like_uint32():
    start = np.full((2, phg.NBUCKETS), 2**32 - 3, np.uint32)
    vals = np.array([0, 0, 0, 0, 0, 7, 7], np.int32)
    ones = np.ones(len(vals), bool)
    jh = jhg.record(jnp.asarray(start), 1, jnp.asarray(vals), jnp.asarray(ones))
    ph = phg.record(u32.from_numpy(start), 1, torch.as_tensor(vals), torch.as_tensor(ones))
    assert np.array_equal(_hist_np(ph), np.asarray(jh))
    assert _hist_np(ph)[1, 0] == 2  # 2^32 - 3 + 5 wrapped


def test_record_count_equal_jax():
    jh, ph = jhg.init(2), phg.init(2)
    for v in (0, 1, 3, 64, 2**31 - 1, -4):
        jh = jhg.record_count(jh, 1, jnp.int32(v))
        ph = phg.record_count(ph, 1, torch.tensor(v, dtype=torch.int32))
    assert np.array_equal(_hist_np(ph), np.asarray(jh))


def test_record_weighted_equals_repeated_lanes():
    """The scalable engine's rumor-age track: w[i] observations of v[i]
    equal the same lanes repeated (negative values dropped), mod 2^32."""
    rng = np.random.default_rng(4)
    vals = rng.integers(-5, 300, 64).astype(np.int32)
    weights = rng.integers(0, 9, 64).astype(np.int32)
    rep_vals = np.repeat(vals, weights)
    jh = jhg.record(jhg.init(2), 0, jnp.asarray(rep_vals), jnp.ones(len(rep_vals), bool))
    ph = phg.record_weighted(phg.init(2), 0, torch.as_tensor(vals), torch.as_tensor(weights))
    assert np.array_equal(_hist_np(ph), np.asarray(jh))


def test_bucket_counts_chunks_agree(monkeypatch):
    idx = torch.as_tensor(np.random.default_rng(5).integers(0, phg.NBUCKETS + 1, 1000))
    whole = phg.bucket_counts(idx)
    monkeypatch.setattr(phg, "_CHUNK", 37)
    assert torch.equal(phg.bucket_counts(idx), whole)
    assert int(whole.sum()) == int((idx < phg.NBUCKETS).sum())
