"""The port's threefry recipes against ``jax.random``, bit for bit.

``ringpop_tpu_torch.ops.threefry`` reproduces ``PRNGKey``, ``split``, 32-bit
random bits, float32 ``uniform`` and int32 ``randint`` under JAX's default
``threefry2x32`` with partitionable counters.  Every output must equal the
JAX one exactly (tolerance: none) on 32+ seeds, on shapes (1,), (7,),
(256,), (4096,) and (1000, 3), and for ``randint`` at upper bounds 64, 100,
4096, 100,000 and 1,000,000 (the last ones reach the uint32 wrap of
``(hi % span) * (2^32 % span)``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu_torch.ops import threefry, u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

SEEDS = list(range(28)) + [0x520337, 12345678, 2**31 - 1, 2**32 - 1]
SHAPES = [(1,), (7,), (256,), (4096,), (1000, 3)]
HIGHS = [64, 100, 4096, 100_000, 1_000_000]


def _keys(seed):
    return jax.random.PRNGKey(np.uint32(seed)), threefry.prng_key(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_uniform_randint_equal_jax(seed):
    jk, pk = _keys(seed)
    assert pk.dtype == torch.int32 and pk.shape == (2,)
    assert np.array_equal(u32.to_numpy(pk), np.asarray(jk))
    for num in (2, 5):
        assert np.array_equal(u32.to_numpy(threefry.split(pk, num)),
                              np.asarray(jax.random.split(jk, num))), num
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        assert np.array_equal(u32.to_numpy(threefry.random_bits32(pk, shape)), want), shape
        want = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.float32))
        got = threefry.uniform_f32(pk, shape).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), shape
        for hi in HIGHS:
            want = np.asarray(jax.random.randint(jk, shape, 0, hi, dtype=jnp.int32))
            got = threefry.randint_i32(pk, shape, 0, hi).numpy()
            assert got.dtype == np.int32 and np.array_equal(got, want), (shape, hi)


def test_split_keys_chain_like_jax():
    """The plane's pattern: split a key five ways, draw from each child,
    carry the last child to the next tick."""
    jk, pk = _keys(0x520337 ^ 1)
    for _ in range(6):
        jks = jax.random.split(jk, 5)
        pks = threefry.split(pk, 5)
        assert np.array_equal(u32.to_numpy(pks), np.asarray(jks))
        want = np.asarray(jax.random.randint(jks[0], (300,), 0, 64, dtype=jnp.int32))
        assert np.array_equal(threefry.randint_i32(pks[0], (300,), 0, 64).numpy(), want)
        jk, pk = jks[4], pks[4]


def test_randint_offsets_and_empty_span_like_jax():
    jk, pk = _keys(7)
    for lo, hi in ((-50, 50), (10, 11), (5, 5), (9, 3), (-(2**31), 2**31 - 1)):
        want = np.asarray(jax.random.randint(jk, (513,), lo, hi, dtype=jnp.int32))
        assert np.array_equal(threefry.randint_i32(pk, (513,), lo, hi).numpy(), want), (lo, hi)


def test_uniform_range_like_jax():
    jk, pk = _keys(11)
    for lo, hi in ((0.0, 1.0), (-2.5, 3.25), (0.1, 0.7)):
        want = np.asarray(jax.random.uniform(jk, (777,), jnp.float32, lo, hi))
        got = threefry.uniform_f32(pk, (777,), lo, hi).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (lo, hi)


def test_randint_rejects_bounds_past_int32():
    _, pk = _keys(0)
    with pytest.raises(ValueError):
        threefry.randint_i32(pk, (4,), 0, 2**31)
