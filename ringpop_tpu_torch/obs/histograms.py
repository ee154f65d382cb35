"""Host half of the device latency histograms: exact percentile
extraction, track summaries, and the ``hist.drain`` runlog row shape.

A copy of ``ringpop_tpu/obs/histograms.py`` over the port's device half,
:mod:`ringpop_tpu_torch.ops.histogram` (log2-bucketed
``[tracks, NBUCKETS]`` uint32 counters carried through the scan).  This
module drains those counters to the host and answers the questions the
reference's ``metrics.Histogram`` answers — count/min/max/p50/p95/p99 —
plus the ``hist.drain`` run-log row.  The counters may be numpy uint32
arrays or the port's int32 tensors of uint32 bit patterns
(:func:`host_counts`).  The JAX module's host twins (``HostHistogram``,
``AdaptiveProtocolPeriod``) have no caller in the port and are not
copied; its statsd sink is not ported yet (ROADMAP.md queue A item 7).

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
    ``recorder`` (a RunRecorder); ``statsd`` raises (not ported yet).
    Returns the summary; the CALLER owns
    the device-side reset — sinks run first, so a raising sink leaves
    the window on device for a retry (the drain_events contract)."""
    if statsd is not None:
        raise NotImplementedError(
            "the statsd sink of the histogram drain is not ported yet "
            "(ROADMAP.md queue A item 7, A13)"
        )
    summary = summarize(hist, tracks, qs)
    if recorder is not None:
        recorder.record_event("hist.drain", **drain_row(source, summary))
    return summary


__all__: List[str] = [
    "drain",
    "drain_row",
    "percentile",
    "percentile_bucket",
    "summarize",
    "summarize_batched",
    "summarize_track",
]
