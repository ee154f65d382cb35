"""Request-trace record layout and host-side decoding for the routing plane.

Counterpart of the host half of ``ringpop_tpu/obs/requests.py``, copied so
that the port imports nothing of the JAX package: the record layout the
device half (``models/route/reqtrace.py``) writes, the decoders and the
``reqtrace.drain`` row.  One row of the record buffer is one sampled
routed request, ``RECORD_WIDTH`` int32 slots::

    [tick, key, sender, dest, owner_truth,
     misroute, reroute, retry_depth, multi, outcome]

``key`` is the uint32 ring-position hash as its int32 bit pattern;
``reroute`` is 0 none, 1 local, 2 remote; ``outcome`` is a bitmask (1
checksums differed, 2 rejected under enforce_consistency, 4 keys
diverged).  ``req_counts`` holds, per ``COUNT_FIELDS`` slot, the matching
``RouteMetrics`` counter restricted to sampled requests.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

RECORD_WIDTH = 10
FIELDS = (
    "tick",
    "key",
    "sender",
    "dest",
    "owner_truth",
    "misroute",
    "reroute",
    "retry_depth",
    "multi",
    "outcome",
)
# field slot indices (device and host must agree)
(
    F_TICK,
    F_KEY,
    F_SENDER,
    F_DEST,
    F_OWNER_TRUTH,
    F_MISROUTE,
    F_REROUTE,
    F_RETRY_DEPTH,
    F_MULTI,
    F_OUTCOME,
) = range(RECORD_WIDTH)

# reroute codes
RR_NONE = 0
RR_LOCAL = 1
RR_REMOTE = 2

# outcome bitmask
OUT_CHECKSUMS_DIFFER = 1
OUT_CHECKSUM_REJECT = 2
OUT_KEYS_DIVERGED = 4

# Device-side sampled-subset counters (RouteState.req_counts slots, in
# order): each is the matching RouteMetrics counter restricted to
# sampled requests — ``cnt(mask & sampled)`` on device under the SAME
# mask the metric sums.
COUNT_FIELDS = (
    "queries",
    "misroutes",
    "reroute_local",
    "reroute_remote",
    "keys_diverged",
    "checksums_differ",
    "checksum_rejects",
)


def decode_arrays(buf: Any, head: Any) -> Dict[str, np.ndarray]:
    """Device buffer -> {field: np.ndarray} over the ``head`` valid
    rows (the cheap columnar form; ``key`` is returned as uint32)."""
    buf = np.asarray(buf)
    if buf.ndim != 2 or buf.shape[1] != RECORD_WIDTH:
        raise ValueError(
            "request buffer must be [cap, %d] int32, got %r"
            % (RECORD_WIDTH, buf.shape)
        )
    head = int(np.asarray(head))
    head = max(0, min(head, buf.shape[0]))
    rows = buf[:head]
    out = {name: rows[:, i].copy() for i, name in enumerate(FIELDS)}
    out["key"] = rows[:, F_KEY].astype(np.int32).view(np.uint32).copy()
    return out


def decode_requests(
    buf: Any, head: Any, drops: Any = 0
) -> List[Dict[str, int]]:
    """Device buffer -> list of per-request dicts.  A nonzero ``drops``
    (RouteState.req_drops) annotates every row: the buffer filled and
    the TAIL of the stream is missing — new records are dropped, never
    overwritten, so the prefix is honest."""
    arrs = decode_arrays(buf, head)
    out: List[Dict[str, int]] = []
    for i in range(len(arrs["tick"])):
        out.append({name: int(arrs[name][i]) for name in FIELDS})
    if int(np.asarray(drops)):
        for req in out:
            req.setdefault("truncated_stream", True)
    return out


def counts_dict(req_counts: Any) -> Dict[str, int]:
    """RouteState.req_counts -> {COUNT_FIELDS name: int}."""
    arr = np.asarray(req_counts).reshape(-1)
    if arr.shape[0] != len(COUNT_FIELDS):
        raise ValueError(
            "req_counts must have %d slots, got %r"
            % (len(COUNT_FIELDS), arr.shape)
        )
    return {name: int(arr[i]) for i, name in enumerate(COUNT_FIELDS)}


def drain_row(
    source: str,
    records: int,
    drops: int,
    cap: int,
    sample_log2: int,
    counts: Dict[str, int],
    **extra: object,
) -> Dict[str, object]:
    """The ``reqtrace.drain`` runlog event row (field set validated by
    scripts/check_metrics_schema.py)."""
    row: Dict[str, object] = {
        "source": source,
        "records": int(records),
        "drops": int(drops),
        "cap": int(cap),
        "sample_log2": int(sample_log2),
        "counts": dict(counts),
    }
    row.update(extra)
    return row


def drain(
    buf: Any,
    head: Any,
    drops: Any,
    req_counts: Any,
    sample_log2: int,
    source: str = "route",
    recorder=None,
    statsd=None,
) -> Dict[str, object]:
    """The host half of ``RoutedStorm.drain_requests()``: decode the
    window and log the ``reqtrace.drain`` event row on ``recorder`` (a
    ``RunRecorder``).  Returns {"records": [...], "drops", "cap",
    "counts", ...}; the caller owns the device-side reset, after the sink
    ran.  The statsd sink of the JAX drain is not ported yet: passing one
    raises."""
    if statsd is not None:
        raise NotImplementedError(
            "the request-trace drain's statsd sink is not ported yet "
            "(ROADMAP.md queue A item 7, A13)"
        )
    cap = int(np.asarray(buf).shape[0])
    records = decode_requests(buf, head, drops)
    counts = counts_dict(req_counts)
    n_drops = int(np.asarray(drops))
    row = drain_row(
        source, len(records), n_drops, cap, sample_log2, counts
    )
    if recorder is not None:
        recorder.record_event("reqtrace.drain", **row)
    out = dict(row)
    out["records"] = records
    return out
