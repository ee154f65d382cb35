"""Device-side sampled per-request trace buffer for the routing plane.

Counterpart of ``ringpop_tpu/models/route/reqtrace.py``.  A deterministic
hash-of-key Bernoulli sample picks ~2^-sample_log2 of the key space; every
routed request whose key is sampled appends one fixed-width int32 record
(layout: :mod:`ringpop_tpu_torch.obs.requests`) to a linear buffer carried
in the route state.  Appends are masked rank scatters; a full buffer drops
and counts (``req_drops``), never overwrites.  Beside the records,
``req_counts`` sums each ``RouteMetrics`` mask over the sampled subset.
Every field is write-only: the plane never reads it back, so tracing
leaves the trajectory alone.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ringpop_tpu_torch.obs import requests as rq
from ringpop_tpu_torch.ops.record_mix import record_mix


def max_requests_per_tick(queries_per_tick: int) -> int:
    """Upper bound on the records one routing tick appends (every query
    sendable, every key sampled)."""
    return queries_per_tick


def req_capacity_for(queries_per_tick: int, ticks: int) -> int:
    """Drop-free capacity for a ``ticks``-tick window at worst case."""
    return ticks * max_requests_per_tick(queries_per_tick)


def init_reqtrace_fields(capacity: int, device="cpu"):
    """(req_buf, req_head, req_drops, req_counts, req_tick) initial
    values — the RouteState request-trace plane."""
    def zero():
        return torch.zeros((), dtype=torch.int32, device=device)

    return (
        torch.zeros((capacity, rq.RECORD_WIDTH), dtype=torch.int32, device=device),
        zero(),
        zero(),
        torch.zeros(len(rq.COUNT_FIELDS), dtype=torch.int32, device=device),
        zero(),
    )


def sample_mask(key_hashes: torch.Tensor, salt: int, sample_log2: int) -> torch.Tensor:
    """[Q] bool — hash-of-key Bernoulli sample at rate 2^-sample_log2: the
    key hash re-mixed with a dedicated salt, low ``sample_log2`` bits
    zero."""
    if sample_log2 == 0:
        return torch.ones(key_hashes.shape, dtype=torch.bool, device=key_hashes.device)
    z = torch.zeros_like(key_hashes)
    h = record_mix(key_hashes, z + salt, z)
    return (h & ((1 << sample_log2) - 1)) == 0


def append_requests(
    buf: torch.Tensor,  # [cap, RECORD_WIDTH] int32
    head: torch.Tensor,  # [] int32
    drops: torch.Tensor,  # [] int32
    mask: torch.Tensor,  # [Q] bool — which lanes append a record
    columns: Tuple[torch.Tensor, ...],  # RECORD_WIDTH lanes ([Q] or [])
):
    """Masked append of up to Q records: selected lanes are ranked by a
    cumulative sum and written at ``head + rank``; lanes past the capacity
    go to a spare row and bump the drop counter.  Returns (buf, head,
    drops) as new tensors."""
    cap = buf.shape[0]
    q = mask.shape[0]
    mask_i = mask.to(torch.int32)
    total = mask_i.sum(dtype=torch.int32)
    rank = torch.cumsum(mask_i, dim=0, dtype=torch.int32) - 1
    pos = head + rank
    tgt = torch.where(mask & (pos < cap), pos, cap).long()
    rec = torch.stack([c.to(torch.int32).expand(q) for c in columns], dim=1)
    out = torch.cat([buf, buf.new_zeros(1, buf.shape[1])])
    out[tgt] = rec
    head_new = torch.clamp(head + total, max=cap)
    drops = drops + torch.clamp(head + total - cap, min=0)
    return out[:cap], head_new, drops


def record_tick_requests(state, params, kh, senders, dest, own_truth, sendable, misroute,
                         reroute_local, reroute_remote, differ, rejects, multi_ok, diverged,
                         retried):
    """Append this tick's sampled requests and bump the sampled counters;
    returns ``state`` with new ``req_*`` fields.  Every argument is one of
    ``route_tick``'s own masks or lanes."""
    tick = state.req_tick + 1
    sampled = sample_mask(kh, params.req_salt, params.req_sample_log2)
    rec_mask = sendable & sampled

    def b(m):  # bool -> int32 lane
        return m.to(torch.int32)

    reroute = b(reroute_local) * rq.RR_LOCAL + b(reroute_remote) * rq.RR_REMOTE
    outcome = (
        b(differ) * rq.OUT_CHECKSUMS_DIFFER
        + b(rejects) * rq.OUT_CHECKSUM_REJECT
        + b(diverged) * rq.OUT_KEYS_DIVERGED
    )
    buf, head, drops = append_requests(
        state.req_buf, state.req_head, state.req_drops, rec_mask,
        (tick, kh, senders, dest, own_truth, b(misroute), reroute, b(retried), b(multi_ok),
         outcome),
    )
    # slot order == obs.requests.COUNT_FIELDS
    masks = (sendable, misroute, reroute_local, reroute_remote, diverged, differ, rejects)
    counts = state.req_counts + (torch.stack(masks) & sampled).sum(dim=1, dtype=torch.int32)
    return state._replace(
        req_buf=buf, req_head=head, req_drops=drops, req_counts=counts, req_tick=tick,
    )
