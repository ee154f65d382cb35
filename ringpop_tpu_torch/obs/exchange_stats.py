"""Host half of the exchange telemetry: the single-device drain.

A copy of ``ringpop_tpu/obs/exchange_stats.py`` over the port's device
half: the ``exch``/``exch_hist`` planes of
:class:`ringpop_tpu_torch.models.sim.engine_scalable.ScalableState` —
per-shard uint32 counters in :data:`ringpop_tpu_torch.ops.exchange.
EXCH_COUNTERS` order plus per-direction cap-utilization log2 histograms,
accumulated by the analytic S-shard twin of the mesh plane
(``engine_scalable._exchange_obs_update``).  This module drains those
counters to the host, prices the wire bytes exactly
(:func:`ringpop_tpu_torch.ops.exchange.drain_exchange_counters`), logs one
``mesh.exchange.drain`` run-log row per shard and reconciles the measured
bytes against the analytic traffic model
(:func:`ringpop_tpu_torch.ops.exchange.cross_shard_traffic_bytes`) and
emits the ``sharded.exchange.*`` statsd keys through the port's
``obs.statsd_bridge``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ringpop_tpu_torch.obs import histograms as oh
from ringpop_tpu_torch.ops import exchange as _exch

# the runlog event name (field set pinned by scripts/check_metrics_schema
# and tests/obs/test_runlog_schema.py in lockstep with
# ExchangeMetrics._fields)
EXCHANGE_DRAIN_EVENT = "mesh.exchange.drain"
# extras every drain row carries next to the ExchangeMetrics fields
EXCHANGE_DRAIN_EXTRAS = ("source", "shards", "w", "cap", "local_rows")
# one measured-vs-model reconciliation row per drained window (the
# reconcile() dict + a source tag; schema-gated like the drain rows)
TRAFFIC_RECONCILE_EVENT = "traffic_reconcile"

# counter fields summed across shards into the drain summary's totals
# (every ExchangeMetrics field except the shard id)
TOTAL_FIELDS = tuple(
    f for f in _exch.ExchangeMetrics._fields if f != "shard"
)


def totals(rows: Sequence[_exch.ExchangeMetrics]) -> Dict[str, int]:
    """Cross-shard sums of every counter field (+ ``shards``): the
    aggregate view the statsd bridge and the traffic gate consume."""
    out: Dict[str, int] = {"shards": len(rows)}
    for f in TOTAL_FIELDS:
        out[f] = int(sum(getattr(r, f) for r in rows))
    return out


def measured_interconnect_bytes(tot: Dict[str, int]) -> int:
    """Wire bytes that actually crossed shard boundaries: the drained
    byte totals price the FULL a2a/all-gather buffers (every slot,
    self-shard bucket included); exactly the (S-1)/S cross fraction of
    those slots leaves the source shard — the same fraction the
    analytic model charges (``cross_shard_traffic_bytes``)."""
    s = int(tot["shards"])
    if s <= 1:
        return 0
    full = int(tot["wire_bytes_pull"]) + int(tot["wire_bytes_push"])
    # exact: full is a multiple of s by construction (s buckets/shard)
    return full * (s - 1) // s


def reconcile(
    tot: Dict[str, int],
    *,
    n: int,
    w: int,
    cap: Optional[int] = None,
) -> Dict[str, object]:
    """Measured-vs-model interconnect reconciliation for one drained
    window: measured bytes (from the device counters) against
    ``cross_shard_traffic_bytes(...)["interconnect_total"] * ticks``.
    Exact equality (ratio 1.0) whenever every trip took the a2a path;
    fallback trips are surfaced so the gate can band or forbid them."""
    s = int(tot["shards"])
    ticks = int(tot["ticks"]) // s if s else 0
    model = _exch.cross_shard_traffic_bytes(n, w, s, cap=cap)
    model_bytes = int(model["interconnect_total"]) * ticks
    measured = measured_interconnect_bytes(tot)
    return {
        "shards": s,
        "n": int(n),
        "w": int(w),
        "cap": int(model["cap"]),
        "ticks": ticks,
        "measured_interconnect": measured,
        "model_interconnect": model_bytes,
        "ratio": (measured / model_bytes) if model_bytes else None,
        "fallback_trips": int(tot["fallback_pull"])
        + int(tot["fallback_push"]),
    }


def drain(
    counters,
    hist=None,
    *,
    w: int,
    local_rows: int,
    source: str,
    cap: Optional[int] = None,
    recorder=None,
    statsd=None,
    qs: Sequence[float] = oh.DEFAULT_QS,
) -> Dict[str, object]:
    """The ONE host half of every driver's ``drain_exchange_metrics()``
    (the single-device ScalableCluster twin; the mesh driver is A11):
    price the device counters into per-shard :class:`ExchangeMetrics` rows, log
    one ``mesh.exchange.drain`` event per shard on ``recorder``, emit the
    summed ``sharded.exchange.*`` keys through ``statsd`` (an
    ``obs.statsd_bridge.StatsdBridge``), and return ``{"shards": [row dicts],
    "totals": {...}, "cap_util": {...}, "reconcile": {...}}``.  Sinks run before any caller-side reset — a raising sink
    leaves the window on device for a retry (the drain_events
    contract, same as obs.histograms.drain)."""
    counters = oh.host_counts(counters)
    rows = _exch.drain_exchange_counters(
        counters, w=w, cap=cap, local_rows=local_rows
    )
    shards = len(rows)
    cap_r = (
        _exch.exchange_cap(local_rows, shards) if cap is None else int(cap)
    )
    cap_util = (
        None
        if hist is None
        else oh.summarize_batched(
            oh.host_counts(hist), _exch.EXCH_HIST_TRACKS, qs
        )
    )
    tot = totals(rows)
    # n is recoverable from the drain identity (local_rows x shards), so
    # every drained window ships its own measured-vs-model verdict
    rec = reconcile(tot, n=int(local_rows) * shards, w=w, cap=cap)
    if recorder is not None:
        for r in rows:
            recorder.record_event(
                EXCHANGE_DRAIN_EVENT,
                source=source,
                shards=shards,
                w=int(w),
                cap=cap_r,
                local_rows=int(local_rows),
                **r._asdict(),
            )
        recorder.record_event(
            TRAFFIC_RECONCILE_EVENT, source=source, **rec
        )
    if statsd is not None:
        statsd.emit_exchange_drain(tot)
        if cap_util is not None:
            from ringpop_tpu_torch.obs.statsd_bridge import EXCHANGE_HIST_KEYS

            statsd.emit_hist_summary(cap_util, key_map=EXCHANGE_HIST_KEYS)
    return {
        "shards": [r._asdict() for r in rows],
        "totals": tot,
        "cap_util": cap_util,
        "reconcile": rec,
    }


__all__: List[str] = [
    "EXCHANGE_DRAIN_EVENT",
    "EXCHANGE_DRAIN_EXTRAS",
    "TOTAL_FIELDS",
    "TRAFFIC_RECONCILE_EVENT",
    "drain",
    "measured_interconnect_bytes",
    "reconcile",
    "totals",
]
