"""Incremental hash-prefix-bucketed consistent-hash ring.

Counterpart of ``ringpop_tpu/models/route/ring_kernel.py``, held against it
bit for bit (tests/test_torch_route_ring.py).  The model is the JAX
module's:

- the static ``[N, R]`` replica table is partitioned once into ``2^B``
  buckets by the top B bits of each point's hash; within a bucket the
  points are pre-sorted by their ``(hash << 32) | owner`` key, so a
  bucket's active subset, in order, is a mask-compaction: no sort;
- the ring state caches, per bucket, the compacted active keys, padded
  with the bucket's upper-boundary PAD key ``((b+1) << (64-B)) - 1``.
  Churn dirties only the buckets holding a flipped server's points; an
  update re-compacts those rows and leaves the rest.  Past the static
  caps (``max_changed`` servers, ``max_dirty`` buckets) it re-compacts
  every bucket instead (the overflow fallback);
- the flattened ``[2^B * M]`` segment table is globally sorted with the
  PADs interleaved, so a lookup is one ``searchsorted``; a PAD hit
  (owner word all ones, -1) takes the next non-empty bucket's first
  owner (``next_owner``), an off-the-end hit wraps to ``first_owner``.

Port conventions:

- keys are uint64 and torch compares int64 as signed, so every key tensor
  here holds the key with its sign bit flipped (``key ^ 2^63``), as the
  port's device ring does (``models/ring/device.py``).  The flip leaves
  the low (owner) word alone, so a PAD's owner still decodes to -1.  The
  PAD keys are computed on the host in numpy uint64 (the last bucket's pad
  wraps to ``2^64 - 1``), flipped there, and kept in ``RingBuckets.pads``;
- ``jnp.nonzero(size=k, fill_value=f)`` is a fixed-size rank scatter
  (:func:`_first_k`), with no host sync;
- ``.at[].set(mode="drop")`` scatters into one spare slot that is sliced
  off;
- the JAX ``lax.cond`` between the incremental path and the fallback reads
  ``overflow`` on the host once per update (``engine_scalable.host_read``:
  one device sync, counted with the engine's).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ringpop_tpu_torch.models.ring.device import _flipped_const, _flipped_keys
from ringpop_tpu_torch.models.sim.engine_scalable import host_read
from ringpop_tpu_torch.ops import u32

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


class RingBuckets(NamedTuple):
    """Static hash-prefix partition of the [N, R] replica table (built
    once per universe by :func:`build_buckets`).  ``2^B = keys.shape[0]``,
    ``M = keys.shape[1]`` (the largest static bucket)."""

    keys: torch.Tensor  # [2^B, M] int64 flipped keys, in-bucket sorted; PAD-padded
    owners: torch.Tensor  # [2^B, M] int32 — key's owner (-1 on PAD slots)
    point_bucket: torch.Tensor  # [N, R] int32 — bucket id of each replica point
    pads: torch.Tensor  # [2^B] int64 — each bucket's flipped PAD key


class RingState(NamedTuple):
    """Dynamic bucketed ring: per-bucket active keys compacted to the row
    front, PAD-padded; refreshed incrementally by :func:`update`."""

    seg_keys: torch.Tensor  # [2^B, M] int64 flipped keys
    count: torch.Tensor  # [2^B] int32 — active points per bucket
    mask: torch.Tensor  # [N] bool — the membership this state reflects
    n_points: torch.Tensor  # [] int32 — total active points
    first_owner: torch.Tensor  # [] int32 — owner of the global min key (-1 empty)
    next_owner: torch.Tensor  # [2^B] int32 — first active owner strictly after b (wraps)


def default_bucket_bits(n: int, replica_points: int, target_load: int = 192) -> int:
    """B such that the mean bucket holds ~``target_load`` static points,
    clamped to [1, 16]."""
    total = max(1, n * replica_points)
    return max(1, min(16, int(math.log2(max(2, total // target_load)))))


def _flip_u64(a: np.ndarray) -> np.ndarray:
    """uint64 keys -> their flipped int64 values."""
    return (np.asarray(a, np.uint64) ^ np.uint64(1 << 63)).view(np.int64)


def build_buckets(replica_hashes, bucket_bits: int, device="cpu") -> RingBuckets:
    """Partition the static replica table (``[N, R]`` uint32 numpy, or the
    port's int32 view) into 2^B hash-prefix buckets, on the host, once per
    universe."""
    if not (1 <= bucket_bits <= 20):
        raise ValueError("bucket_bits must be in [1, 20], got %d" % bucket_bits)
    if isinstance(replica_hashes, torch.Tensor):
        replica_hashes = u32.to_numpy(replica_hashes)
    hashes = np.asarray(replica_hashes, dtype=np.uint32)
    n, r = hashes.shape
    nb = 1 << bucket_bits
    owners = np.broadcast_to(np.arange(n, dtype=np.uint64)[:, None], (n, r))
    keys = (hashes.astype(np.uint64) << np.uint64(32)) | owners
    bucket = (hashes >> np.uint32(32 - bucket_bits)).astype(np.int64)
    flat_keys = keys.reshape(-1)
    flat_bucket = bucket.reshape(-1)
    counts = np.bincount(flat_bucket, minlength=nb)
    cap = max(1, int(counts.max()))
    # global ascending key order == (bucket, in-bucket key) order, since
    # the bucket id is the key's top B bits
    order = np.argsort(flat_keys, kind="stable")
    sorted_bucket = flat_bucket[order]
    starts = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(flat_keys.size, dtype=np.int64) - starts[sorted_bucket]
    pad_vals = ((np.arange(nb, dtype=np.uint64) + np.uint64(1))
                << np.uint64(64 - bucket_bits)) - np.uint64(1)
    skeys = np.broadcast_to(pad_vals[:, None], (nb, cap)).copy()
    sowners = np.full((nb, cap), -1, dtype=np.int32)
    skeys[sorted_bucket, within] = flat_keys[order]
    sowners[sorted_bucket, within] = (flat_keys[order] & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return RingBuckets(
        keys=torch.from_numpy(_flip_u64(skeys)).to(device),
        owners=torch.from_numpy(sowners).to(device),
        point_bucket=torch.from_numpy(bucket.astype(np.int32)).to(device),
        pads=torch.from_numpy(_flip_u64(pad_vals)).to(device),
    )


def _first_k(flags: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(flags, size=k, fill_value=fill)[0]`` as int64: the
    indices of the first ``k`` set flags in order, ``fill`` past them."""
    rank = torch.cumsum(flags.to(torch.int32), dim=0, dtype=torch.int32) - 1
    tgt = torch.where(flags & (rank < k), rank, k).long()
    out = torch.full((k + 1,), fill, dtype=torch.int64, device=flags.device)
    out.scatter_(0, tgt, torch.arange(flags.shape[0], dtype=torch.int64, device=flags.device))
    return out[:k]


def _compact_rows(
    keys: torch.Tensor,  # [K, M] int64 static keys
    pads: torch.Tensor,  # [K] int64 PAD key of each row
    active: torch.Tensor,  # [K, M] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row stable mask-compaction of pre-sorted keys: active keys move
    to the row front (order kept), the tail is PAD.  O(M), no sort."""
    k, m = keys.shape
    pos = torch.cumsum(active.to(torch.int32), dim=1, dtype=torch.int32) - 1
    rows = torch.arange(k, dtype=torch.int64, device=keys.device)[:, None]
    tgt = torch.where(active, rows * m + pos, k * m)
    seg = torch.cat([pads[:, None].expand(k, m).reshape(-1),
                     pads.new_zeros(1)])
    seg.scatter_(0, tgt.reshape(-1), keys.reshape(-1))
    cnt = active.sum(dim=1, dtype=torch.int32)
    return seg[: k * m].reshape(k, m), cnt


def _derive(seg_keys: torch.Tensor, count: torch.Tensor, mask: torch.Tensor) -> RingState:
    """Refresh the lookup helpers (first/next owner, totals) from the
    per-bucket segments — O(2^B)."""
    nb = count.shape[0]
    dev = count.device
    nonempty = count > 0
    firsts = torch.where(nonempty, u32.from_u64(seg_keys[:, 0]), -1)
    # smallest non-empty bucket index at-or-after b (a reversed running
    # min), then shifted for strictly-after with wraparound
    idx = torch.where(nonempty, torch.arange(nb, dtype=torch.int32, device=dev), 2 * nb)
    at_or_after = torch.flip(torch.cummin(torch.flip(idx, (0,)), dim=0).values, (0,))
    first_idx = at_or_after[0]
    after = torch.cat([at_or_after[1:], idx.new_full((1,), 2 * nb)])
    nxt_idx = torch.where(after < 2 * nb, after, first_idx)
    ring_nonempty = first_idx < 2 * nb
    next_owner = torch.where(ring_nonempty, firsts[nxt_idx.clamp(0, nb - 1).long()], -1)
    # a one-element gather: indexing with a 0-d tensor would read it on the host
    first = firsts.index_select(0, first_idx.clamp(0, nb - 1).long().reshape(1))[0]
    first_owner = torch.where(ring_nonempty, first, -1)
    return RingState(
        seg_keys=seg_keys,
        count=count,
        mask=mask,
        n_points=count.sum(dtype=torch.int32),
        first_owner=first_owner,
        next_owner=next_owner,
    )


def _active(owners: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Which static slots hold a point of a server in ``mask``."""
    n = mask.shape[0]
    return mask[owners.clamp(0, n - 1).long()] & (owners >= 0)


def full_rebuild(buckets: RingBuckets, mask: torch.Tensor) -> RingState:
    """Re-compact every bucket from the static table and ``mask`` —
    O(N·R) elementwise, no sort.  The init path and the overflow fallback
    of :func:`update`."""
    seg, cnt = _compact_rows(buckets.keys, buckets.pads, _active(buckets.owners, mask))
    return _derive(seg, cnt, mask)


def dirty_stats(
    buckets: RingBuckets,
    changed: torch.Tensor,  # [N] bool — servers whose ring membership flipped
    max_changed: int,
    max_dirty: int,
):
    """(n_changed, dirty mask [2^B], n_dirty, overflow): what the
    incremental path does, shared with the full-sort twin's metrics."""
    n = changed.shape[0]
    nb = buckets.keys.shape[0]
    n_changed = changed.sum(dtype=torch.int32)
    c_idx = _first_k(changed, max_changed, n)
    pb = buckets.point_bucket[c_idx.clamp(0, n - 1)]
    pb = torch.where((c_idx < n)[:, None], pb, nb)
    # index_fill, not ``dirty[idx] = True``: on a card the latter copies the
    # lifted scalar to the device, a synchronous upload every tick
    dirty = torch.zeros(nb + 1, dtype=torch.bool, device=changed.device).index_fill(
        0, pb.reshape(-1).long(), True)
    dirty = dirty[:nb]
    n_dirty = dirty.sum(dtype=torch.int32)
    overflow = (n_changed > max_changed) | (n_dirty > max_dirty)
    return n_changed, dirty, n_dirty, overflow


def update(
    buckets: RingBuckets,
    state: RingState,
    new_mask: torch.Tensor,
    *,
    max_changed: int,
    max_dirty: int,
):
    """Incremental ring maintenance: re-merge only the dirty buckets.

    Returns ``(state', n_changed, n_dirty, full_rebuilds)``;
    ``full_rebuilds`` is 1 iff the churn overflowed the caps and the update
    fell back to :func:`full_rebuild` (the same state either way)."""
    nb, m = buckets.keys.shape
    changed = new_mask != state.mask
    n_changed, dirty, n_dirty, overflow = dirty_stats(buckets, changed, max_changed, max_dirty)
    if host_read(overflow):
        new_state = full_rebuild(buckets, new_mask)
    else:
        d_idx = _first_k(dirty, max_dirty, nb)
        dc = d_idx.clamp(0, nb - 1)
        o_rows = buckets.owners[dc]
        seg_rows, cnt_rows = _compact_rows(
            buckets.keys[dc], buckets.pads[dc], _active(o_rows, new_mask)
        )
        # rows past the dirty count land in the spare row nb
        seg = torch.cat([state.seg_keys, state.seg_keys.new_zeros(1, m)])
        seg[d_idx] = seg_rows
        cnt = torch.cat([state.count, state.count.new_zeros(1)])
        cnt[d_idx] = cnt_rows
        new_state = _derive(seg[:nb], cnt[:nb], new_mask)
    return new_state, n_changed, n_dirty, overflow.to(torch.int32)


def materialize(state: RingState, total_points: int) -> torch.Tensor:
    """Flatten the bucketed state into the flat sorted ring layout —
    ``[total_points]`` int64 flipped keys, ascending, padded with the
    flipped all-ones sentinel — equal to ``device.build_ring(replica
    hashes, state.mask)``."""
    nb, m = state.seg_keys.shape
    dev = state.seg_keys.device
    slot = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    active = slot < state.count[:, None]
    starts = torch.cumsum(state.count, dim=0, dtype=torch.int64) - state.count
    tgt = torch.where(active, starts[:, None] + slot, total_points)
    out = torch.full((total_points + 1,), _flipped_const(SENTINEL), dtype=torch.int64,
                     device=dev)
    out.scatter_(0, tgt.reshape(-1), state.seg_keys.reshape(-1))
    return out[:total_points]


def lookup(state: RingState, key_hashes: torch.Tensor) -> torch.Tensor:
    """Batched owner lookup on the bucketed ring: [Q] int32 (uint32) key
    hashes -> [Q] int32 owners (-1 when the ring is empty)."""
    nb, m = state.seg_keys.shape
    total = nb * m
    q = _flipped_keys(key_hashes, torch.zeros((), dtype=torch.int64, device=key_hashes.device))
    flat = state.seg_keys.reshape(-1)
    i = torch.searchsorted(flat, q)
    ic = i.clamp(0, total - 1)
    owner = u32.from_u64(flat[ic])
    own = torch.where(owner < 0, state.next_owner[torch.div(ic, m, rounding_mode="floor")], owner)
    own = torch.where(i >= total, state.first_owner, own)
    return torch.where(state.n_points > 0, own, -1)


def lookup_n_fixed(
    ring: torch.Tensor,  # flat sorted ring (device.build_ring / materialize)
    n_points: torch.Tensor,
    key_hash: torch.Tensor,  # [] or [Q] int32 (uint32)
    n: int,
    width: int,
):
    """Fixed-width W-successor twin of ``device.lookup_n``: read ``width``
    successor slots, keep first-occurrence owners, the first ``n`` of
    them.  Returns ``(owners [..., n] int32 -1-padded, found [...])``.

    Equal to the successor walk whenever ``found == n`` or ``width >=
    n_points`` (the window saw the whole ring).  ``key_hash`` may carry a
    batch dimension (the JAX function is vmapped for batches)."""
    dev = ring.device
    query = _flipped_keys(key_hash, torch.zeros((), dtype=torch.int64, device=dev))
    start = torch.searchsorted(ring, query.reshape(-1)).reshape(query.shape)
    steps = torch.arange(width, dtype=torch.int64, device=dev)
    npts = n_points.clamp(min=1).to(torch.int64)
    idx = torch.remainder(start[..., None] + steps, npts)
    owners = u32.from_u64(ring[idx])
    visited = steps < n_points
    owners = torch.where(visited, owners, -1)
    eq = owners[..., :, None] == owners[..., None, :]
    dup = torch.tril(eq, diagonal=-1).any(dim=-1)
    is_new = visited & ~dup
    rank = torch.cumsum(is_new.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    found = is_new.sum(dim=-1, dtype=torch.int32)
    tgt = torch.where(is_new & (rank < n), rank, n).long()
    out = torch.full((*owners.shape[:-1], n + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(-1, tgt, owners)
    out = out[..., :n]
    empty = n_points <= 0
    return (
        torch.where(empty, -1, out),
        torch.where(empty, 0, torch.clamp(found, max=n)),
    )
