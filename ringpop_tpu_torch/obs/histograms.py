"""Host half of the device latency histograms: exact percentile
extraction, track summaries, and the ``hist.drain`` runlog row shape.

A copy of ``ringpop_tpu/obs/histograms.py`` over the port's device half,
:mod:`ringpop_tpu_torch.ops.histogram` (log2-bucketed
``[tracks, NBUCKETS]`` uint32 counters carried through the scan).  This
module drains those counters to the host and answers the questions the
reference's ``metrics.Histogram`` answers — count/min/max/p50/p95/p99 —
plus the ``hist.drain`` run-log row.  The counters may be numpy uint32
arrays or the port's int32 tensors of uint32 bit patterns
(:func:`host_counts`).  The host twins ``HostHistogram``,
``compute_protocol_delay`` and ``AdaptiveProtocolPeriod`` (the
``computeProtocolDelay`` consumer ``obs.perf`` reads) are copied too; the
statsd sink is the port's ``obs.statsd_bridge``.

Percentile semantics (exact, given the bucketization): the q-th
percentile is the nearest-rank order statistic — the ``ceil(q/100 * N)``
-th smallest observation.  Bucketization is monotone, so the bucket
found by walking cumulative bucket counts to that rank is EXACTLY the
bucket containing the true order statistic of the raw values; the
returned ``lo``/``hi`` bracket it, and ``value`` (the reported scalar)
is the conservative upper bound ``hi``.  Pinned against a raw-value
numpy oracle in tests/obs/test_histograms.py, including empty and
top-bucket (overflow-range) cases.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops import u32

DEFAULT_QS = (50, 95, 99)


def host_counts(hist) -> np.ndarray:
    """Counters as a host numpy array: a torch tensor holds uint32 bit
    patterns in int32 (ops/u32.py) and comes back as uint32."""
    if isinstance(hist, torch.Tensor):
        return u32.to_numpy(hist)
    return np.asarray(hist)


def percentile_bucket(counts: np.ndarray, q: float) -> Optional[int]:
    """Bucket index holding the nearest-rank q-th percentile, or None
    for an empty histogram.  ``counts`` is one track's [NBUCKETS]."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return None
    if not (0 < q <= 100):
        raise ValueError("q must be in (0, 100], got %r" % (q,))
    rank = max(1, math.ceil(q / 100.0 * total))
    cum = np.cumsum(counts)
    return int(np.searchsorted(cum, rank, side="left"))


def percentile(counts: np.ndarray, q: float) -> Optional[Dict[str, int]]:
    """{"bucket", "lo", "hi", "value"} for the q-th percentile (value ==
    the bucket upper bound hi), or None when the track is empty."""
    b = percentile_bucket(counts, q)
    if b is None:
        return None
    return {
        "bucket": b,
        "lo": hg.bucket_lo(b),
        "hi": hg.bucket_hi(b),
        "value": hg.bucket_hi(b),
    }


def summarize_track(
    counts: np.ndarray, qs: Sequence[float] = DEFAULT_QS
) -> Dict[str, object]:
    """One track's summary: count, occupied-bucket min/max bounds, and
    the requested percentiles as ``p<q>`` entries."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    out: Dict[str, object] = {"count": total}
    nz = np.nonzero(counts)[0]
    out["min_lo"] = int(hg.bucket_lo(int(nz[0]))) if total else None
    out["max_hi"] = int(hg.bucket_hi(int(nz[-1]))) if total else None
    for q in qs:
        p = percentile(counts, q)
        key = "p%g" % q
        out[key] = None if p is None else p["value"]
        out[key + "_lo"] = None if p is None else p["lo"]
    return out


def summarize(
    hist,
    tracks: Sequence[str],
    qs: Sequence[float] = DEFAULT_QS,
) -> Dict[str, Dict[str, object]]:
    """Track-name-keyed summaries of one drained ``[H, NBUCKETS]``
    counter array (device or host)."""
    arr = host_counts(hist)
    if arr.ndim != 2:
        raise ValueError(
            "summarize wants one [tracks, buckets] array, got shape %r "
            "(use summarize_batched for a vmapped [B, H, NB] drain)"
            % (arr.shape,)
        )
    if arr.shape[0] != len(tracks):
        raise ValueError(
            "hist has %d tracks but %d names given"
            % (arr.shape[0], len(tracks))
        )
    return {
        name: summarize_track(arr[i], qs) for i, name in enumerate(tracks)
    }


def summarize_batched(
    hist,
    tracks: Sequence[str],
    qs: Sequence[float] = DEFAULT_QS,
    aggregate: bool = True,
) -> object:
    """A vmapped driver's ``[B, H, NBUCKETS]`` (or deeper-batched)
    histogram stack.  ``aggregate=True`` sums the batch axes first —
    bucket counts are additive, so the aggregate percentiles are exactly
    the percentiles of the pooled observations; ``False`` returns a list
    of per-instance summaries (leading axes flattened)."""
    arr = host_counts(hist)
    if arr.ndim < 2:
        raise ValueError("batched hist needs >= 2 dims, got %r" % (arr.shape,))
    if arr.ndim == 2:
        return summarize(arr, tracks, qs)
    flat = arr.reshape(-1, arr.shape[-2], arr.shape[-1])
    if aggregate:
        return summarize(flat.sum(axis=0), tracks, qs)
    return [summarize(h, tracks, qs) for h in flat]


def drain_row(
    source: str,
    summary: Dict[str, Dict[str, object]],
    **extra: object,
) -> Dict[str, object]:
    """The ``hist.drain`` runlog event row (field set validated by
    scripts/check_metrics_schema.py): source + per-track summaries."""
    row: Dict[str, object] = {"source": source, "tracks": summary}
    row.update(extra)
    return row


def drain(
    hist,
    tracks: Sequence[str],
    source: str,
    recorder=None,
    statsd=None,
    qs: Sequence[float] = DEFAULT_QS,
) -> Dict[str, Dict[str, object]]:
    """The ONE host half of every driver's ``drain_histograms()``:
    summarize the device counters, log the ``hist.drain`` event row on
    ``recorder`` (a RunRecorder), emit percentile timer keys through
    ``statsd`` (an ``obs.statsd_bridge.StatsdBridge``).  Returns the
    summary; the CALLER owns
    the device-side reset — sinks run first, so a raising sink leaves
    the window on device for a retry (the drain_events contract)."""
    summary = summarize(hist, tracks, qs)
    if recorder is not None:
        recorder.record_event("hist.drain", **drain_row(source, summary))
    if statsd is not None:
        statsd.emit_hist_summary(summary)
    return summary


# -- host-side log2 histogram (the perf timers' accumulator) --------------


class HostHistogram:
    """A host-side twin of the device counters: same log2 buckets, same
    percentile extraction — used by obs.perf's dispatch timers so
    wall-clock distributions and device-side latency distributions share
    one summary/rendering path.  Values are bucketized at a caller-chosen
    resolution (``unit`` — e.g. 1e-4 s per unit keeps sub-millisecond
    timing resolution in the low buckets)."""

    def __init__(self, unit: float = 1.0):
        if unit <= 0:
            raise ValueError("unit must be positive")
        self.unit = unit
        self.counts = np.zeros(hg.NBUCKETS, np.int64)

    def observe(self, value: float) -> None:
        if value < 0:
            return
        b = int(hg.bucket_index_np(np.int64(value / self.unit)))
        self.counts[b] += 1

    def summary(self, qs: Sequence[float] = DEFAULT_QS) -> Dict[str, object]:
        out = summarize_track(self.counts, qs)
        # scale the bucket bounds back to value units
        for k, v in list(out.items()):
            if k != "count" and v is not None:
                out[k] = v * self.unit
        return out


# -- the load-bearing consumer: adaptive protocol period ------------------


def compute_protocol_delay(
    p50: Optional[float], min_protocol_period: float = 200.0
) -> float:
    """The reference's ``computeProtocolDelay`` formula
    (lib/gossip/index.js:42-50): twice the ping-timing histogram's
    median, floored at the minimum protocol period.  ``p50 = None``
    (no observations yet) keeps the floor — exactly the reference's
    behavior before the first ping lands a timing sample."""
    if p50 is None:
        return float(min_protocol_period)
    return float(max(2.0 * p50, min_protocol_period))


class AdaptiveProtocolPeriod:
    """Host-side adaptive-period model fed from a ping-latency
    histogram — ``computeProtocolDelay``-style, OFF by default (nothing
    constructs one unless asked; the engines' discrete clock stays
    fixed).  Feed per-ping (per-tick dispatch) latencies in ms via
    ``observe``; ``period_ms()`` is ``max(2 * p50, min_period_ms)``
    with p50 read from the log2 histogram's conservative upper bound."""

    def __init__(self, min_period_ms: float = 200.0, unit_ms: float = 1.0):
        self.min_period_ms = float(min_period_ms)
        self.hist = HostHistogram(unit=unit_ms)

    def observe(self, latency_ms: float) -> None:
        self.hist.observe(latency_ms)

    def p50_ms(self) -> Optional[float]:
        s = self.hist.summary(qs=(50,))
        return s["p50"]

    def period_ms(self) -> float:
        return compute_protocol_delay(self.p50_ms(), self.min_period_ms)


__all__: List[str] = [
    "AdaptiveProtocolPeriod",
    "HostHistogram",
    "compute_protocol_delay",
    "drain",
    "drain_row",
    "percentile",
    "percentile_bucket",
    "summarize",
    "summarize_batched",
    "summarize_track",
]
