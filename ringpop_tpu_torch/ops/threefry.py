"""The pieces of ``jax.random`` the routing plane draws from, bit for bit.

The JAX routing plane keeps its traffic RNG as a legacy threefry key
(``jax.random.PRNGKey``) and draws with ``split``, ``uniform`` and
``randint`` under JAX's defaults: the ``threefry2x32`` generator with
``jax_threefry_partitionable=True``.  This module reproduces exactly those
recipes on the port's uint32-as-int32 storage (:mod:`.u32`); a key is a
``[2]`` int32 tensor holding the bits of JAX's ``uint32[2]`` key.

- ``threefry2x32``: 20 rounds with rotations (13, 15, 26, 6) and
  (17, 29, 16, 24), key schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``, a key
  injection (plus the round count) every four rounds;
- the partitionable counter layout: element ``i`` of a shape hashes the
  64-bit counter ``i`` as the word pair ``(i >> 32, i & 0xFFFFFFFF)``;
  ``split`` stacks the two output words into new keys, 32-bit random bits
  are the XOR of the two words;
- ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  one, then JAX's ``* (max - min) + min`` (one fused multiply-add on the
  XLA CPU backend) and ``max(min, .)``;
- ``randint``: two 32-bit draws from ``split(key)``, combined as
  ``((hi % span) * (2^32 % span) + lo % span) % span`` in uint32
  arithmetic that wraps (at span ~ 10^6 the product passes 2^32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ringpop_tpu_torch.ops import u32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = u32.s32(0x1BD11BDA)
_ONE_F32_BITS = 0x3F800000


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(uint32(seed))``: the key ``[0, seed]``."""
    return torch.tensor([0, u32.s32(seed)], dtype=torch.int32, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | u32.srl(x, 32 - r)


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _KS_PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def _counter_bits(key: torch.Tensor, shape):
    """The two output words for the partitionable counters of ``shape``
    (the 64-bit iota's high word is 0 below 2^32 elements)."""
    size = math.prod(shape)
    if size >= 2**32:
        raise ValueError("threefry counters past 2^32 elements are not supported")
    lo = torch.arange(size, dtype=torch.int64, device=key.device)
    lo = u32.from_u64(lo).reshape(shape)
    return threefry2x32(key, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` int32 keys."""
    b0, b1 = _counter_bits(key, (num,))
    return torch.stack([b0, b1], dim=1)


def random_bits32(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (int32 storage): ``bits1 ^ bits2``."""
    b0, b1 = _counter_bits(key, tuple(shape))
    return b0 ^ b1


def uniform_f32(key: torch.Tensor, shape, minval: float = 0.0,
                maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = u32.srl(random_bits32(key, shape), 9) | _ONE_F32_BITS
    floats = bits.view(torch.float32) - 1.0
    # XLA's CPU backend contracts ``floats * (hi - lo) + lo`` into one
    # fused multiply-add: the exact float64 product, one rounding
    scaled = (floats.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp_min(scaled, float(lo))


def randint_i32(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)`` for
    Python int bounds inside the int32 range."""
    if not (-(2**31) <= minval < 2**31 and -(2**31) <= maxval < 2**31):
        raise ValueError("randint_i32 bounds must lie in the int32 range")
    k = split(key, 2)
    higher = u32.to_u64(random_bits32(k[0], shape))
    lower = u32.to_u64(random_bits32(k[1], shape))
    span = (maxval - minval) & u32.MASK if maxval > minval else 1
    # 2^32 mod span, as JAX forms it in uint32: (2^16 % span)^2 % span
    mult = (2**16) % span
    mult = ((mult * mult) & u32.MASK) % span
    offset = (((higher % span) * mult + lower % span) & u32.MASK) % span
    return u32.from_u64(offset + minval)
