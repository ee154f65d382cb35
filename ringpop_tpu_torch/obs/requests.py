"""Request-trace record layout and host-side decoding for the routing plane.

Counterpart of the host half of ``ringpop_tpu/obs/requests.py``, copied so
that the port imports nothing of the JAX package: the record layout the
device half (``models/route/reqtrace.py``) writes, the decoders, the two
reconciliations (records against the sampled counters, the sampled
counters against the window's ``RouteMetrics``), the per-key span trees,
the Perfetto export (``export_request_trace``) and the ``reqtrace.drain``
row.  Everything here is host-only numpy.  One row of the record buffer is one sampled
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

# count field -> the RouteMetrics field it is the sampled restriction of
METRIC_FIELDS: Dict[str, str] = {
    "queries": "route_queries",
    "misroutes": "route_misroutes",
    "reroute_local": "route_reroute_local",
    "reroute_remote": "route_reroute_remote",
    "keys_diverged": "route_keys_diverged",
    "checksums_differ": "route_checksums_differ",
    "checksum_rejects": "route_checksum_rejects",
}


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


# how to derive each sampled counter from the decoded record stream
_RECORD_DERIVE = {
    "queries": lambda a: int(len(a["tick"])),
    "misroutes": lambda a: int(np.sum(a["misroute"])),
    "reroute_local": lambda a: int(np.sum(a["reroute"] == RR_LOCAL)),
    "reroute_remote": lambda a: int(np.sum(a["reroute"] == RR_REMOTE)),
    "keys_diverged": lambda a: int(
        np.sum((a["outcome"] & OUT_KEYS_DIVERGED) != 0)
    ),
    "checksums_differ": lambda a: int(
        np.sum((a["outcome"] & OUT_CHECKSUMS_DIFFER) != 0)
    ),
    "checksum_rejects": lambda a: int(
        np.sum((a["outcome"] & OUT_CHECKSUM_REJECT) != 0)
    ),
}


def reconcile_records(
    buf: Any, head: Any, req_counts: Any
) -> Dict[str, Dict[str, object]]:
    """Decoded records vs the device-side sampled counters.  On a
    drop-free window every field must match exactly; with drops the
    records are a prefix, so records <= counts.  Returns
    {field: {"records": n, "counts": n, "match": bool}}."""
    arrs = decode_arrays(buf, head)
    counts = counts_dict(req_counts)
    out: Dict[str, Dict[str, object]] = {}
    for field in COUNT_FIELDS:
        r = _RECORD_DERIVE[field](arrs)
        c = counts[field]
        out[field] = {"records": r, "counts": c, "match": r == c}
    return out


def reconcile_metrics(
    req_counts: Any, metrics: Any
) -> Dict[str, Dict[str, object]]:
    """Sampled counters vs the window's RouteMetrics totals: the
    sampled restriction can never exceed the full count, and at
    sample_log2=0 (sample everything) the two are EQUAL.  Returns
    {count field: {"sampled": n, "total": n, "ok": bool}} where ok
    means sampled <= total."""
    counts = counts_dict(req_counts)
    if hasattr(metrics, "_asdict"):
        metrics = metrics._asdict()
    out: Dict[str, Dict[str, object]] = {}
    for field, mfield in METRIC_FIELDS.items():
        if mfield not in metrics:
            continue
        total = int(np.asarray(metrics[mfield]).sum())
        sampled = counts[field]
        out[field] = {
            "sampled": sampled,
            "total": total,
            "ok": sampled <= total,
        }
    return out


# -- per-key span trees ------------------------------------------------------


def outcome_label(req: Dict[str, int]) -> str:
    """One human label per request, worst outcome first."""
    o = int(req["outcome"])
    if o & OUT_KEYS_DIVERGED:
        return "abort.keys-diverged"
    if o & OUT_CHECKSUM_REJECT:
        return "reject.checksum"
    r = int(req["reroute"])
    if r == RR_REMOTE:
        return "reroute.remote"
    if r == RR_LOCAL:
        return "reroute.local"
    if int(req["misroute"]):
        return "misroute"
    return "ok"


def request_span(req: Dict[str, int]) -> Dict[str, Any]:
    """One request's span tree: the root send span plus one child span
    per lifecycle stage that fired (checksum mismatch, retry, reroute,
    abort) — the requestProxy story send.js tells per request, rebuilt
    from one record."""
    children: List[Dict[str, Any]] = []
    o = int(req["outcome"])
    if o & OUT_CHECKSUMS_DIFFER:
        children.append(
            {
                "name": "checksums-differ",
                "rejected": bool(o & OUT_CHECKSUM_REJECT),
            }
        )
    if int(req["retry_depth"]) > 0:
        retry: Dict[str, Any] = {"name": "retry", "children": []}
        r = int(req["reroute"])
        if r == RR_LOCAL:
            retry["children"].append(
                {"name": "reroute.local", "dest": int(req["sender"])}
            )
        elif r == RR_REMOTE:
            retry["children"].append(
                {"name": "reroute.remote", "dest": int(req["owner_truth"])}
            )
        if o & OUT_KEYS_DIVERGED:
            retry["children"].append({"name": "abort.keys-diverged"})
        children.append(retry)
    return {
        "name": "request",
        "tick": int(req["tick"]),
        "key": int(req["key"]),
        "sender": int(req["sender"]),
        "dest": int(req["dest"]),
        "outcome": outcome_label(req),
        "multi": bool(req["multi"]),
        "children": children,
    }


def span_trees(requests: Any) -> Dict[int, List[Dict[str, Any]]]:
    """Decoded requests grouped into per-key span trees: {key hash:
    [request span, ...]} ordered by tick.  Sampling is per KEY, so a
    sampled key's list is its complete traced lifecycle across the
    window."""
    if requests and isinstance(requests[0], dict):
        reqs = requests
    else:
        raise TypeError(
            "span_trees wants decode_requests output (list of dicts)"
        )
    by_key: Dict[int, List[Dict[str, Any]]] = {}
    for req in sorted(reqs, key=lambda r: (r["tick"], r["sender"])):
        by_key.setdefault(int(req["key"]), []).append(request_span(req))
    return by_key


# -- Perfetto export ---------------------------------------------------------

REQ_PID = 2  # request tracks ride their own process (cluster = 1, host = 0)


def export_request_trace(
    requests: List[Dict[str, int]],
    n: int,
    period_ms: int = 200,
    pid: int = REQ_PID,
) -> Dict[str, Any]:
    """Decoded sampled requests -> Trace Event Format dict: one track
    (thread) per SENDER node, one complete ``"X"`` span per request
    (duration scales with retry depth — a retried request spans two
    protocol periods), flow arrows (``"s"``/``"t"``) from the sender's
    span to the truth owner's track for remote reroutes.  Merges
    cleanly with the flight-recorder export (distinct pid)."""
    out: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "routed requests (sampled, n=%d)" % n},
        }
    ]
    senders = sorted({int(r["sender"]) for r in requests})
    for s in senders:
        out.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": s,
                "name": "thread_name",
                "args": {"name": "sender %d" % s},
            }
        )
    us = int(period_ms) * 1000
    for i, req in enumerate(requests):
        ts = int(req["tick"]) * us
        depth = int(req["retry_depth"])
        span = {
            "ph": "X",
            "pid": pid,
            "tid": int(req["sender"]),
            "ts": ts,
            "dur": us * (1 + depth),
            "name": outcome_label(req),
            "cat": "request",
            "args": {k: int(req[k]) for k in FIELDS},
        }
        out.append(span)
        if int(req["reroute"]) == RR_REMOTE and int(req["owner_truth"]) >= 0:
            fid = "req-%d" % i
            out.append(
                {
                    "ph": "s",
                    "pid": pid,
                    "tid": int(req["sender"]),
                    "ts": ts,
                    "id": fid,
                    "name": "reroute",
                    "cat": "request",
                }
            )
            out.append(
                {
                    "ph": "t",
                    "pid": pid,
                    "tid": int(req["owner_truth"]),
                    "ts": ts + us,
                    "id": fid,
                    "name": "reroute",
                    "cat": "request",
                }
            )
    return {"traceEvents": out}


# -- drain -------------------------------------------------------------------


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
    window, log the ``reqtrace.drain`` event row on ``recorder`` (a
    ``RunRecorder``), emit the sampled counters through ``statsd`` (an
    ``obs.statsd_bridge.StatsdBridge``).  Returns {"records": [...],
    "drops", "cap", "counts", ...}; the caller owns the device-side reset,
    after the sinks ran."""
    cap = int(np.asarray(buf).shape[0])
    records = decode_requests(buf, head, drops)
    counts = counts_dict(req_counts)
    n_drops = int(np.asarray(drops))
    row = drain_row(
        source, len(records), n_drops, cap, sample_log2, counts
    )
    if recorder is not None:
        recorder.record_event("reqtrace.drain", **row)
    if statsd is not None:
        statsd.emit_reqtrace_drain(row)
    out = dict(row)
    out["records"] = records
    return out
