"""Consistent hash ring over a static node universe, as tensors.

Counterpart of ``ringpop_tpu/models/ring/device.py``.  The ring is data,
not a tree: the universe's replica-point hashes are computed once
(``[N, R]`` uint32), and a rebuild under churn is one sort of the keys
``(hash << 32) | owner`` of the active servers, inactive points pushed to
the end as the all-ones :data:`SENTINEL`.  ``lookup`` is a binary search
(the rbtree's upperBound with wraparound, ring/index.js:145-154);
``lookup_n`` walks successors collecting unique owners
(ring/index.js:157-189).

Unsigned order: the keys are uint64, and torch sorts int64 as signed, so a
hash >= 2^31 would sort before a smaller one.  A ring tensor here holds
every key with its sign bit flipped (``key ^ 2^63`` as int64), whose
signed order is the keys' unsigned order; the sentinel becomes the int64
maximum and still sorts last.  Queries are flipped the same way, and
:func:`ring_checksum` and :func:`ring_to_numpy` unflip.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ringpop_tpu_torch.ops import farmhash32, u32
from ringpop_tpu_torch.ops.record_mix import record_mix

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # the unflipped key of an empty point
_SIGN64 = -(2**63)
_MASK32 = 0xFFFFFFFF


def replica_table(addresses: Sequence[str], replica_points: int = 100) -> np.ndarray:
    """[N, R] uint32 replica-point hashes hash32(addr + str(i)) of the
    static universe (host-side, once per run)."""
    return np.stack([
        farmhash32.hash32_strings(["%s%d" % (a, i) for i in range(replica_points)])
        for a in addresses
    ]).astype(np.uint32)


def _flipped_keys(hashes: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """int64 ``((hash << 32) | low) ^ 2^63`` from int32 (uint32) hashes and
    non-negative int64 ``low`` words: the flipped hash's signed value
    ``hash - 2^31`` times 2^32 never overflows int64."""
    return ((hashes ^ u32.s32(0x80000000)).to(torch.int64) << 32) | low


def build_ring(replica_hashes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sorted key table of the active ring.

    ``replica_hashes``: [N, R] int32 (uint32); ``mask``: [N] bool (server
    in ring).  Returns [N*R] int64 flipped keys (module docstring), the
    inactive entries last as the flipped sentinel."""
    n, r = replica_hashes.shape
    owners = torch.arange(n, dtype=torch.int64, device=mask.device)[:, None]
    keys = _flipped_keys(replica_hashes, owners.expand(n, r))
    keys = torch.where(mask[:, None], keys, _flipped_const(SENTINEL))
    return torch.sort(keys.reshape(-1)).values


def _flipped_const(key: np.uint64) -> int:
    """The flipped int64 value of an unsigned 64-bit key."""
    return int(key) - 2**63


def ring_to_numpy(ring: torch.Tensor) -> np.ndarray:
    """The ring's uint64 keys (unflipped), as the JAX ring holds them."""
    return (ring ^ _SIGN64).to("cpu").numpy().view(np.uint64)


def device_replica_hashes(n: int, replica_points: int, device="cpu") -> torch.Tensor:
    """[N, R] int32 (uint32) replica-point hashes of the integer node ids
    (no address strings at 100k-1M nodes)."""
    ids = torch.arange(n, dtype=torch.int32, device=device)[:, None]
    reps = torch.arange(replica_points, dtype=torch.int32, device=device)[None, :]
    return record_mix(ids, reps, torch.tensor(0x5EED, dtype=torch.int64, device=device))


def ring_checksum(ring: torch.Tensor) -> torch.Tensor:
    """Order-sensitive [] int32 (uint32) digest of a ring table (the scale
    analog of hash32 over sorted server names, lib/ring/index.js:96-105)."""
    key = ring ^ _SIGN64
    x = u32.from_u64(key)  # owner word
    y = (key >> 32) & _MASK32  # hash word, as a non-negative int64
    pos = torch.arange(ring.shape[0], dtype=torch.int32, device=ring.device)
    return u32.row_sum(record_mix(pos, x, y), dim=0)


def ring_size(mask: torch.Tensor, replica_points: int) -> torch.Tensor:
    return mask.sum(dtype=torch.int32) * replica_points


def _upper_bound(ring: torch.Tensor, key_hash: torch.Tensor) -> torch.Tensor:
    """First index with point hash >= key_hash (the reference rbtree's
    ``upperBound`` is a lower bound, rbtree.js:235-271)."""
    query = _flipped_keys(key_hash.to(torch.int32), torch.zeros((), dtype=torch.int64,
                                                                   device=ring.device))
    return torch.searchsorted(ring, query.reshape(-1)).reshape(query.shape).to(torch.int32)


def _owner(ring: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return u32.from_u64(ring[idx.long()])


def lookup(ring: torch.Tensor, n_points: torch.Tensor, key_hash: torch.Tensor) -> torch.Tensor:
    """Owner index for ``key_hash`` (int32; -1 when the ring is empty).
    ``key_hash`` is an int32 (uint32) tensor of any shape."""
    idx = _upper_bound(ring, key_hash)
    idx = torch.where(idx >= n_points, 0, idx)  # wraparound to min()
    return torch.where(n_points > 0, _owner(ring, idx), -1)


def lookup_n(ring: torch.Tensor, n_points: torch.Tensor, key_hash: torch.Tensor,
             n: int) -> torch.Tensor:
    """Up to ``n`` unique successor owners of one key (int32, -1 padded):
    the reference's successor walk with its full-cycle guard
    (ring/index.js:157-189).  The walk reads successors in chunks that
    double until ``n`` owners are found or the whole ring was visited."""
    found = torch.full((n,), -1, dtype=torch.int32, device=ring.device)
    points = int(n_points)
    if points <= 0 or n <= 0:
        return found
    start = int(_upper_bound(ring, key_hash))
    steps = max(4 * n, 64)
    while True:
        steps = min(steps, points)
        idx = torch.remainder(start + torch.arange(steps, dtype=torch.int64, device=ring.device), points)
        owners = _owner(ring, idx).to("cpu").numpy()
        _, first = np.unique(owners, return_index=True)
        walk = owners[np.sort(first)]  # unique owners in walk order
        if walk.size >= n or steps == points:
            break
        steps *= 2
    got = walk[:n]
    found[: got.size] = torch.as_tensor(got, dtype=torch.int32, device=ring.device)
    return found
