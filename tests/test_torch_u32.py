"""The port's uint32-on-int32 helpers against numpy uint32, bit for bit,
and the engine's RNG helpers against the JAX engine's."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine as jax_engine
from ringpop_tpu_torch.models.sim import engine as port_engine
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _words(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    # the edges: 0, 1, 2^31 - 1, 2^31, 2^32 - 1
    w[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    return w


def test_numpy_roundtrip_is_exact():
    w = _words()
    t = u32.from_numpy(w)
    assert t.dtype == torch.int32
    assert np.array_equal(u32.to_numpy(t), w)


@pytest.mark.parametrize("k", [0, 1, 7, 13, 15, 16, 19, 31])
def test_logical_shift_and_rotate(k):
    w = _words(1)
    t = u32.from_numpy(w)
    assert np.array_equal(u32.to_numpy(u32.srl(t, k)), w >> np.uint32(k))
    want_rot = (w >> np.uint32(k)) | (w << np.uint32((32 - k) % 32)) if k else w
    assert np.array_equal(u32.to_numpy(u32.rotr(t, k)), want_rot)
    shifts = np.full(w.shape, k, np.int32)
    assert np.array_equal(
        u32.to_numpy(u32.srl_var(t, torch.as_tensor(shifts))), w >> np.uint32(k)
    )


def test_wrapping_add_mul_match_uint32():
    a, b = _words(2), _words(3)
    ta, tb = u32.from_numpy(a), u32.from_numpy(b)
    assert np.array_equal(u32.to_numpy(ta + tb), a + b)
    assert np.array_equal(u32.to_numpy(ta * tb), a * b)
    assert np.array_equal(u32.to_numpy(ta * u32.s32(0xCC9E2D51)), a * np.uint32(0xCC9E2D51))


def test_unsigned_compares():
    a, b = _words(4), _words(5)
    b[:5] = a[:5]  # equal pairs too
    ta, tb = u32.from_numpy(a), u32.from_numpy(b)
    for fn, op in ((u32.ult, np.less), (u32.ule, np.less_equal),
                   (u32.ugt, np.greater), (u32.uge, np.greater_equal)):
        assert np.array_equal(fn(ta, tb).numpy(), op(a, b)), fn.__name__


def test_row_sum_wraps_mod_2_32():
    w = _words(6, 64 * 70).reshape(64, 70)
    got = u32.to_numpy(u32.row_sum(u32.from_numpy(w), dim=1))
    assert np.array_equal(got, w.sum(axis=1, dtype=np.uint32))


def test_float_conversion_rounds_like_numpy():
    w = _words(7, 1 << 16)
    # values just around float32 rounding boundaries
    w[5:12] = [2**24 + 1, 2**25 + 3, 2**31 + 129, 2**32 - 129, 2**32 - 128, 16777217, 33554435]
    got = u32.to_f32(u32.from_numpy(w)).numpy()
    assert np.array_equal(got, w.astype(np.float32))


@pytest.mark.parametrize("salt", [7, 13, 29, 77, 101])
def test_uniform_and_fold_match_jax_engine(salt):
    rng = np.random.default_rng(salt)
    keys = rng.integers(1, 2**32 - 1, size=(48, 2), dtype=np.uint32)
    jk, tk = jnp.asarray(keys), u32.from_numpy(keys)
    for shape in ((48,), (48, 2), (48, 48)):
        want = np.asarray(jax_engine._uniform(jk, shape, salt))
        got = port_engine._uniform(tk, shape, salt).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, want), shape
    assert np.array_equal(
        u32.to_numpy(port_engine._fold(tk, salt)), np.asarray(jax_engine._fold(jk, salt))
    )
