"""Fused push-pull exchange of the scalable engine: plain version and CUDA
kernel.

Counterpart of ``ringpop_tpu/ops/exchange.py`` (lines 73-527: the op, its
traffic model and the exchange telemetry's layout and host pricing).  The
scalable engine's gossip exchange ORs the pulled and pushed partner rows
into the ``[N, U/32]`` heard bitmask and adds, per row, the rumor deltas
of the bits that turned on (the incremental checksum update)::

    new  = heard | pulled | pushed
    diff = new ^ heard                       # bits only turn ON
    row_delta[i] = sum of r_delta[b] over the set bits b of diff[i]  (mod 2^32)
    new_bits[i]  = popcount(diff[i])         # optional

Every implementation computes the same exact mod-2^32 integer sum, so they
agree bit for bit with each other and with the engine's
``_bit_delta_sum``.  :func:`exchange` launches ``csrc/exchange.cu`` on CUDA
tensors and runs :func:`exchange_plain` on CPU tensors.  The partner-row
gathers stay outside the op, as in the JAX package.

uint32 values are int32 bit patterns (:mod:`ringpop_tpu_torch.ops.u32`).
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ringpop_tpu_torch.ops import _build, toolkit
from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops.u32 import from_u64

WORD = 32

# The kernel's geometry (csrc/exchange.cu and Hopper's shared memory).
THREADS = 256  # threads a block
BLOCKS_PER_SM = 4  # the residency the kernel's __launch_bounds__ promises
SMEM_PER_SM = 233472  # shared memory of an sm_90 SM (228 KB)
SMEM_PER_BLOCK = 1024  # shared memory the card reserves for each resident block
SMEM_TABLE_MAX = 232448 // 4  # table entries a block can stage (227 KB opt-in)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per uint32 word, as int32."""
    return toolkit.popcount(x).to(torch.int32)


def delta_sum_plain(
    words: torch.Tensor, r_delta: torch.Tensor, _chunk_rows: int = 65536
) -> torch.Tensor:
    """[..., N] int32 (uint32): per-row sum of ``r_delta`` over the row's
    set bits, mod 2^32.  ``words``: [..., N, W] masks; ``r_delta``: one
    [U] table for every leading index, or [..., U] tables.  An exact int64
    sum over row chunks of at most ``_chunk_rows`` rows in all, so the
    ``[C, W, 32]`` bit expansion never exists at full ``[N, U]``; no
    floating point (and so no dependence on the TF32 matmul switch)."""
    n, w = words.shape[-2:]
    # [..., 1, W, 32] unsigned deltas: entry (w, b) is rumor w*32+b's
    tbl = (r_delta.to(torch.int64) & 0xFFFFFFFF).reshape(r_delta.shape[:-1] + (1, w, WORD))
    bit_ids = torch.arange(WORD, dtype=torch.int32, device=words.device)
    chunk = max(1, min(n, _chunk_rows // max(1, math.prod(words.shape[:-2]))))

    def row_sums(d):
        bits = (d[..., None] >> bit_ids) & 1  # [..., C, W, 32]
        return from_u64((bits * tbl).sum(dim=(-2, -1)))

    return torch.cat([row_sums(words[..., lo:lo + chunk, :]) for lo in range(0, n, chunk)], dim=-1)


def exchange_plain(
    heard: torch.Tensor,
    pulled: torch.Tensor,
    pushed: torch.Tensor,
    r_delta: torch.Tensor,
    _chunk_rows: int = 65536,
    want_counts: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`exchange` (the counterpart of
    ``exchange_xla``): the same arithmetic as chunked tensor ops.  Takes
    leading batch dims as :func:`delta_sum_plain` does."""
    new = heard | pulled | pushed
    diff = new ^ heard
    acc = delta_sum_plain(diff, r_delta, _chunk_rows)
    cnt = popcount_u32(diff).sum(dim=-1, dtype=torch.int32) if want_counts else None
    return new, acc, cnt


class ExchangePlan(NamedTuple):
    """Launch geometry of ``csrc/exchange.cu`` for one call."""

    vec: int  # words a lane owns: 4 (16-byte lanes) or 1 (4-byte lanes)
    seg: int  # lanes a row spans in one warp, a power of two <= 32
    rows_per_tile: int  # rows a block covers at once (THREADS // seg)
    tiles: int  # row tiles covering N
    blocks: int  # the persistent grid, never more than the tiles
    smem_table: bool  # the delta table is staged in shared memory


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def exchange_plan(n: int, w: int, aligned: bool, sm_count: int, clusters: int = 1) -> ExchangePlan:
    """The kernel's geometry for an [n, w] mask on a card of ``sm_count``
    SMs.  ``aligned``: the three input planes start on 16-byte boundaries.
    ``clusters``: masks stacked on the grid's second axis, which share the
    card's resident blocks (``blocks`` is per cluster).

    4-word lanes where they tile a row with no idle lane (w / 4 a power of
    two up to 32, or a multiple of 32) and the planes are aligned, unless
    their tiles leave the card's blocks idle and 4-byte lanes make more
    tiles (a small n, where a thread's walk over its words, not the
    memory, sets the time); 4-byte lanes otherwise.  A row spans the next
    power of two of its lanes, at most a warp (a lane then takes several
    items of the row).  The grid is as many blocks as the card holds at
    once, at most one a tile: each block stages the delta table once and
    walks tiles with a grid stride."""
    table_bytes = w * WORD * 4
    smem_table = w * WORD <= SMEM_TABLE_MAX
    per_sm = BLOCKS_PER_SM
    if smem_table:
        per_sm = min(per_sm, SMEM_PER_SM // (table_bytes + SMEM_PER_BLOCK))
    capacity = max(1, sm_count * per_sm // max(1, clusters))

    def tiling(vec):
        seg = min(32, _pow2_at_least(w // vec))
        return vec, seg, THREADS // seg, -(-n // (THREADS // seg))

    q = w // 4
    wide = q >= 1 and w % 4 == 0 and ((q & (q - 1)) == 0 and q <= 32 or q % 32 == 0)
    vec, seg, rows_per_tile, tiles = tiling(1)
    if aligned and wide:
        wide_tiling = tiling(4)
        if wide_tiling[3] >= min(capacity, tiles):
            vec, seg, rows_per_tile, tiles = wide_tiling
    return ExchangePlan(vec, seg, rows_per_tile, tiles, min(tiles, capacity), smem_table)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(*planes: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in planes)


def exchange(
    heard: torch.Tensor,
    pulled: torch.Tensor,
    pushed: torch.Tensor,
    r_delta: torch.Tensor,
    *,
    want_counts: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Fused push-pull exchange step.

    ``heard``: [N, U/32] int32 (uint32) pre-exchange reception bitmask;
    ``pulled`` / ``pushed``: [N, U/32] partner-row contributions, already
    masked by delivery and active-rumor words; ``r_delta``: [U] int32
    (uint32) rumor delta table.

    Returns ``(new_heard [N, U/32], row_delta [N] (uint32 bits),
    new_bits [N] int32 or None)``.  ``want_counts=False`` skips the
    popcount output (the engine's hot path consumes only the delta).

    CUDA tensors launch ``csrc/exchange.cu`` with the geometry of
    :func:`exchange_plan`; CPU tensors run :func:`exchange_plain`.  Inside
    ``torch.func.vmap`` the call goes through the custom op
    ``ringpop_torch::exchange``, whose batching rule launches the kernel
    once with a cluster axis (each block stages its own cluster's table)."""
    if toolkit.is_batched(heard, pulled, pushed, r_delta):
        new, acc, cnt = _exchange_op(heard, pulled, pushed, r_delta, want_counts)
        return new, acc, cnt if want_counts else None
    if heard.ndim != 2:
        raise ValueError("exchange wants an [N, U/32] mask, got %r" % (tuple(heard.shape),))
    n, w = heard.shape
    if tuple(r_delta.shape) != (w * WORD,):
        raise ValueError(
            "delta table must cover the mask: [%d] for %d words, got %r"
            % (w * WORD, w, tuple(r_delta.shape))
        )
    if heard.device.type == "cpu":
        return exchange_plain(heard, pulled, pushed, r_delta, want_counts=want_counts)
    return _launch(heard, pulled, pushed, r_delta, want_counts, clusters=None)


def _launch(heard, pulled, pushed, r_delta, want_counts, clusters):
    """One launch over one cluster's ``[N, W]`` planes (``clusters`` None)
    or ``clusters`` stacked ``[B, N, W]`` ones, whose delta tables are
    ``[B, U]`` or one shared ``[U]`` table."""
    dev = heard.device
    n, w = heard.shape[-2:]
    lead = () if clusters is None else (clusters,)
    shared_table = r_delta.ndim == 1
    i32 = torch.int32
    _build.check("exchange", dev, (
        ("heard", heard, i32, lead + (n, w)), ("pulled", pulled, i32, lead + (n, w)),
        ("pushed", pushed, i32, lead + (n, w)),
        ("r_delta", r_delta, i32, ((w * WORD,) if shared_table else lead + (w * WORD,))),
    ))
    new = torch.empty(lead + (n, w), dtype=torch.int32, device=dev)
    acc = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    cnt = torch.empty(lead + (n,), dtype=torch.int32, device=dev) if want_counts else None
    b = 1 if clusters is None else clusters
    plan = exchange_plan(n, w, _aligned(heard, pulled, pushed), _sm_count(dev.index), b)
    ptrs = [_build.ptr(t) for t in (heard, pulled, pushed, r_delta, new, acc, cnt)]
    _build.library().call("ringpop_exchange", ptrs, n, w, plan.vec, plan.seg, plan.blocks,
                          int(plan.smem_table), b, 0 if shared_table else w * WORD)
    exchange.launches += 1
    return new, acc, cnt


exchange.launches = 0


# ---------------------------------------------------------------------------
# the batch axis: B clusters in one launch


def _clusters(heard, pulled, pushed, r_delta, want_counts):
    """B stacked clusters, with ``[B, U]`` tables or one shared ``[U]``
    table: one launch on the card (a shared table is passed once, with a
    zero cluster stride), :func:`exchange_plain` over the batch on the
    CPU."""
    if heard.device.type == "cpu":
        return exchange_plain(heard, pulled, pushed, r_delta, want_counts=want_counts)
    return _launch(heard.contiguous(), pulled.contiguous(), pushed.contiguous(),
                   r_delta.contiguous(), want_counts, clusters=heard.shape[0])


@torch.library.custom_op(toolkit.LIB + "::exchange", mutates_args=())
def _exchange_op(
    heard: torch.Tensor, pulled: torch.Tensor, pushed: torch.Tensor, r_delta: torch.Tensor,
    want_counts: bool,
) -> List[torch.Tensor]:
    """One cluster through the op (the wrapper calls it only inside vmap,
    where the rule below runs instead)."""
    new, acc, cnt = _clusters(heard[None], pulled[None], pushed[None], r_delta, want_counts)
    return [new[0], acc[0], acc.new_empty(0) if cnt is None else cnt[0]]


def _exchange_rule(info, in_dims, heard, pulled, pushed, r_delta, want_counts):
    b = info.batch_size
    planes = [toolkit.batch_front(t, d, b) for t, d in zip((heard, pulled, pushed), in_dims[:3])]
    if in_dims[3] is not None:
        r_delta = r_delta.movedim(in_dims[3], 0)
    new, acc, cnt = _clusters(*planes, r_delta, want_counts)
    if cnt is None:
        return [new, acc, acc.new_empty(0)], [0, 0, None]
    return [new, acc, cnt], [0, 0, 0]


torch.library.register_vmap(toolkit.LIB + "::exchange", _exchange_rule)


def exchange_local(heard, pulled, pushed, r_delta, *, impl: str):
    """Shard-local entry: the exchange on one shard's ``[N/S, U/32]`` rows,
    whose cross-shard partner rows the caller already delivered.  ``impl``
    is "kernel" or "plain" (no resolution inside a shard's body); counts
    are never requested.  Returns ``(new_heard, row_delta)``."""
    if impl == "kernel":
        new, delta, _ = exchange(heard, pulled, pushed, r_delta, want_counts=False)
    elif impl == "plain":
        new, delta, _ = exchange_plain(heard, pulled, pushed, r_delta, want_counts=False)
    else:
        raise ValueError("exchange_local impl must be kernel|plain, got %r" % (impl,))
    return new, delta


def step_traffic_bytes(n: int, w: int) -> int:
    """Modeled device-memory bytes per exchange step: 3 mask reads (heard
    and the two partner-row planes) + 1 mask write + the [N] delta and
    count outputs; the delta table is negligible.  A lower bound."""
    return (3 + 1) * n * w * 4 + 2 * n * 4


def exchange_cap(local_rows: int, shards: int) -> int:
    """Static per-(source shard, destination shard) row cap of the mesh
    exchange plane's all-to-all buckets: mean + 6 sqrt(mean) + 8 of the
    Binomial(L, 1/S) bucket occupancy, never above ``local_rows``."""
    if shards <= 1:
        return local_rows
    mean = -(-local_rows // shards)
    return min(local_rows, mean + 6 * math.isqrt(mean) + 8)


def cross_shard_traffic_bytes(n: int, w: int, shards: int, cap: Optional[int] = None) -> dict:
    """Modeled per-tick interconnect and shard-local bytes of an S-shard
    exchange plane (the JAX package's traffic model): one all-to-all per
    direction of ``cap`` row slots per (source, destination) shard pair,
    of which the (S-1)/S addressed to other shards cross, plus the [S, cap]
    int32 position plane per direction.  ``interconnect_total`` is per
    tick across all shards; the exchange-telemetry drain reconciles its
    measured bytes against it."""
    local_rows = n // shards
    if cap is None:
        cap = exchange_cap(local_rows, shards)
    cross_frac = (shards - 1) / shards
    row_slots = shards * cap * shards  # per direction, all shards
    out = {
        "shards": shards,
        "local_rows": local_rows,
        "cap": cap,
        "interconnect_rows": int(2 * row_slots * w * 4 * cross_frac),
        "interconnect_pos": int(2 * row_slots * 4 * cross_frac),
        "local_fused_total": shards * step_traffic_bytes(local_rows, w),
    }
    out["interconnect_total"] = out["interconnect_rows"] + out["interconnect_pos"]
    return out


# ---------------------------------------------------------------------------
# Per-shard exchange telemetry (ScalableParams.exchange_metrics = S): the
# device half is a [S, len(EXCH_COUNTERS)] counter plane plus [S,
# len(EXCH_HIST_TRACKS), NBUCKETS] cap-utilization histograms (uint32 bit
# patterns), bumped each tick by the engine's analytic S-shard twin of the
# mesh plane; the host half prices the drained trips into exact wire
# bytes (drain_exchange_counters, obs/exchange_stats.py).

# counter layout, one row per shard (the order is the wire format): rounds,
# all-to-all and fallback trips per direction, rows delivered per
# direction, and destination-shard spread per direction
EXCH_COUNTERS = (
    "ticks",
    "a2a_pull",
    "a2a_push",
    "fallback_pull",
    "fallback_push",
    "pull_rows",
    "push_rows",
    "dest_shards_pull",
    "dest_shards_push",
)

# one observation per (round, destination shard): that destination's
# all-to-all bucket occupancy before capping
EXCH_HIST_TRACKS = ("cap_util_pull", "cap_util_push")


class ExchangeMetrics(NamedTuple):
    """One drained per-shard telemetry row (host ints): the counters, the
    shard id and the exact wire bytes they price to."""

    shard: int
    ticks: int
    a2a_pull: int
    a2a_push: int
    fallback_pull: int
    fallback_push: int
    pull_rows: int
    push_rows: int
    dest_shards_pull: int
    dest_shards_push: int
    wire_bytes_pull: int
    wire_bytes_push: int


def init_exchange_counters(shards: int, device="cpu") -> torch.Tensor:
    """Zeroed [shards, len(EXCH_COUNTERS)] counters (uint32 bit patterns)."""
    return torch.zeros((shards, len(EXCH_COUNTERS)), dtype=torch.int32, device=device)


def init_exchange_hist(shards: int, device="cpu") -> torch.Tensor:
    """Zeroed [shards, len(EXCH_HIST_TRACKS), NBUCKETS] cap-utilization
    histograms (ops/histogram.py buckets, uint32 bit patterns)."""
    return torch.zeros((shards, len(EXCH_HIST_TRACKS), hg.NBUCKETS), dtype=torch.int32,
                       device=device)


def a2a_trip_bytes(w: int, shards: int, cap: int) -> int:
    """Exact wire bytes one shard moves per all-to-all trip, one direction:
    the [S, cap, w] uint32 rows plus the [S, cap] int32 positions."""
    return shards * cap * (w * 4 + 4)


def fallback_trip_bytes(local_rows: int, w: int, shards: int) -> int:
    """Exact bytes one shard receives per all-gather fallback trip, one
    direction: the full [N, w] gather."""
    return shards * local_rows * w * 4


def drain_exchange_counters(counters, *, w: int, cap: Optional[int], local_rows: int) -> list:
    """Drained counters (a numpy [S, len(EXCH_COUNTERS)] uint32 array) ->
    per-shard :class:`ExchangeMetrics` rows.  The wire bytes are priced
    here (trips x the static trip size), so the device plane never holds
    a byte count; ``cap=None`` prices the trips at :func:`exchange_cap`."""
    counters = np.asarray(counters)
    shards = counters.shape[0]
    if counters.shape != (shards, len(EXCH_COUNTERS)):
        raise ValueError(
            "counters must be [S, %d], got %r" % (len(EXCH_COUNTERS), counters.shape)
        )
    if cap is None:
        cap = exchange_cap(local_rows, shards)
    a2a_b = a2a_trip_bytes(w, shards, cap)
    fb_b = fallback_trip_bytes(local_rows, w, shards)
    rows = []
    for s in range(shards):
        c = {name: int(counters[s, i]) for i, name in enumerate(EXCH_COUNTERS)}
        rows.append(ExchangeMetrics(
            shard=s,
            wire_bytes_pull=c["a2a_pull"] * a2a_b + c["fallback_pull"] * fb_b,
            wire_bytes_push=c["a2a_push"] * a2a_b + c["fallback_push"] * fb_b,
            **c,
        ))
    return rows
